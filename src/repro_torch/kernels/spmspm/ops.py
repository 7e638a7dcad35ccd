"""Public SpMSpM API (``repro/kernels/spmspm/ops.py``): padded-ELL streams
in, dense or compacted-sparse result out.

The reference pads R and C to whole tiles; the port's kernel bounds-checks
them, and ``rt`` / ``ct`` / ``nt`` only shape its launch (no value changes
the result): ``rt`` A rows (warps) a thread block, ``nt * ct`` output
columns a warp's slab.  The converters run as tensor code on the dense
matrix's device, so the streams of a large matrix are built where it lies.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import as_tensor
from repro_torch.core.formats import INVALID_KEY
from repro_torch.kernels.spmspm.kernel import spmspm_ell

_INVALID = int(INVALID_KEY)


def dense_to_ell_rows(dense, width: Optional[int] = None, *, device=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (R, K) matrix -> padded-ELL (keys, vals) row streams: each
    row's nonzero column ids ascending, then ``INVALID_KEY`` pads (values
    0).  A tensor stays where it lies; a numpy input goes to ``device``
    (default ``"cuda"``)."""
    d = as_tensor(dense, device)
    R, K = d.shape
    mask = d != 0
    counts = mask.sum(dim=1)
    most = int(counts.max()) if R else 0
    width = int(width or max(1, most))
    if most > width:
        raise ValueError(f"dense_to_ell_rows: a row holds {most} nonzeros, "
                         f"more than width {width}")
    cols = torch.where(mask, torch.arange(K, dtype=torch.int32,
                                          device=d.device), K)
    cols = torch.sort(cols, dim=1).values[:, :width]
    if cols.shape[1] < width:
        cols = torch.cat([cols, cols.new_full((R, width - cols.shape[1]), K)],
                         dim=1)
    valid = cols < K
    keys = torch.where(valid, cols, _INVALID).to(torch.int32)
    safe = cols.clamp(max=max(K - 1, 0)).long()
    vals = torch.where(valid, d.gather(1, safe), 0).to(d.dtype)
    return keys, vals


def dense_to_ell_cols(dense, width: Optional[int] = None, *, device=None):
    """Dense matrix -> padded-ELL *column* streams (the CSC view), placed
    as :func:`dense_to_ell_rows` places them."""
    d = as_tensor(dense, device)
    return dense_to_ell_rows(d.T.contiguous(), width)


def spmspm(a_keys, a_vals, b_keys, b_vals, *, rt: Optional[int] = None,
           ct: Optional[int] = None, nt: Optional[int] = None,
           a_scales=None, device=None) -> torch.Tensor:
    """Dense-result SpMSpM over padded-ELL streams (A rows, B columns):
    (R, C) f32.

    ``rt`` / ``ct`` / ``nt`` default to the ``spmspm`` row of
    ``kernels.tuning``, keyed on A's value dtype; ``nt`` is the
    output-column residency (an A row is walked once per slab of ``nt *
    ct`` columns).  ``a_scales`` carries per-row BlockQuant scales of narrow
    ``a_vals``.  Inputs that are tensors run where they lie; numpy inputs
    go to ``device`` (default ``"cuda"``)."""
    if nt is not None and int(nt) < 1:
        raise ValueError(f"nt={nt} must be >= 1")
    ak, av, bk, bv = (as_tensor(x, device).contiguous()
                      for x in (a_keys, a_vals, b_keys, b_vals))
    if a_scales is not None:
        a_scales = as_tensor(a_scales, device).to(
            device=ak.device, dtype=torch.float32).reshape(-1).contiguous()
    return spmspm_ell(ak, av, bk, bv, rt=rt, ct=ct, nt=nt,
                      a_scales=a_scales)


def comparison_stats(a_keys, b_keys, *, device=None) -> dict:
    """Figure of merit (paper Fig. 6c): issued vs useful index comparisons.
    Issued = R * C * La * Lb (the reference's all-pairs sweep); useful = the
    valid A keys found among B's valid keys; useful / issued is the analogue
    of the comparator utilization.  Tensors are read where they lie;
    numpy inputs go to ``device`` (default ``"cuda"``)."""
    ak, bk = as_tensor(a_keys, device), as_tensor(b_keys, device)
    a_valid = ak[ak != _INVALID]
    b_valid = bk[bk != _INVALID]
    return {"issued": int(ak.shape[0] * bk.shape[0] * ak.shape[1]
                          * bk.shape[1]),
            "useful_upper": int(torch.isin(a_valid, b_valid).sum()),
            "valid_a": int(a_valid.numel()),
            "valid_b": int(b_valid.numel())}


def compact_result(dense_c: torch.Tensor, capacity: int):
    """Third-SU write-back: a dense result -> sorted (keys, values, count)
    joint-index stream of its nonzeros, ``capacity`` long."""
    R, C = dense_c.shape
    flat = dense_c.reshape(-1)
    nz = flat != 0
    keys = torch.where(nz, torch.arange(R * C, dtype=torch.int32,
                                        device=flat.device), _INVALID)
    order = torch.argsort(keys, stable=True)[:capacity]
    out_keys = keys[order]
    out_vals = torch.where(out_keys != _INVALID, flat[order], 0)
    count = (out_keys != _INVALID).sum().to(torch.int32)
    return out_keys, out_vals, count
