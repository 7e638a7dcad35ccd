"""Public SpMM API: BCSR containers in, normalized kernel call out.

  * :func:`spmm`         -- one (M, K) ``BCSR`` x (K, N) dense.
  * :func:`spmm_batched` -- ``BatchedBCSR`` (shared index stream, per-batch
    blocks) x (B, K, N) [or a broadcast (K, N)] dense.  The batch is a grid
    dimension of the kernel (the reference vmaps its kernel instead).

A quantized container (narrow blocks + ``scales``) runs K2q; the N-tile then
keys the ``spmm`` row of ``kernels.tuning`` on the narrow block dtype, as
the reference does.  The output defaults to f32, as the reference's.
:func:`spmm` takes ``nt=`` only for signature parity with the reference,
where it is the output-residency width: the port's kernel keeps each thread
block's output tile in registers for its whole row walk, so ``nt`` is
validated and has no effect on the result or the launch.
``pad_empty_rows`` keeps the reference's stream contract (every block-row
appears); the kernel itself also writes zeros for an empty row.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.formats import BCSR, BatchedBCSR
from repro_torch.kernels.spmm.kernel import spmm_bcsr


def pad_empty_rows(a: Union[BCSR, BatchedBCSR]):
    """Ensure every block-row appears in the stream: one zero block at col
    0 (scale 1.0) for each empty row, stream kept (row, col)-sorted.
    Host-side (numpy on the index stream); returns ``a`` itself when no row
    is empty."""
    gm = a.grid_shape[0]
    rows = a.block_rows.cpu().numpy()
    present = np.zeros(gm, bool)
    present[rows] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size == 0:
        return a
    single = isinstance(a, BCSR)
    axis = 0 if single else 1
    lead = () if single else (a.batch,)
    cols = a.block_cols.cpu().numpy()
    rows = np.concatenate([rows, missing])
    cols = np.concatenate([cols, np.zeros_like(missing)])
    order = np.lexsort((cols, rows))
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=gm), out=indptr[1:])
    dev = a.blocks.device
    perm = torch.from_numpy(order).to(dev)
    blocks = torch.cat([a.blocks, a.blocks.new_zeros(
        lead + (missing.size,) + tuple(a.block))], dim=axis)
    scales = None
    if a.scales is not None:
        scales = torch.cat([a.scales, a.scales.new_ones(
            lead + (missing.size,))], dim=axis).index_select(axis, perm)
    kw = dict(indptr=torch.from_numpy(indptr).to(dev),
              block_rows=torch.from_numpy(rows[order]).to(dev),
              block_cols=torch.from_numpy(cols[order]).to(dev),
              blocks=blocks.index_select(axis, perm).contiguous(),
              shape=a.shape, block=a.block, scales=scales)
    return BCSR(**kw) if single else BatchedBCSR(**kw)


def spmm(a: BCSR, dense: torch.Tensor, *, bn: Optional[int] = None,
         nt: Optional[int] = None,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ dense for one (M, K) BCSR matrix and a (K, N) dense operand.
    Returns (M, N) in ``out_dtype``; ``nt`` as in the module docstring."""
    if nt is not None and int(nt) < 1:
        raise ValueError(f"nt={nt} must be >= 1")
    if not isinstance(a, BCSR) or dense.dim() != 2 \
            or dense.shape[0] != a.shape[1]:
        raise ValueError(f"spmm: a BCSR {getattr(a, 'shape', None)} x a "
                         f"(K, N) dense, got {tuple(dense.shape)}")
    a = pad_empty_rows(a)
    return spmm_bcsr(a.indptr, a.block_cols, a.blocks[None],
                     dense.contiguous()[None], out_dtype=out_dtype, bn=bn,
                     scales=None if a.scales is None else a.scales[None])[0]


def spmm_batched(a: BatchedBCSR, dense: torch.Tensor, *,
                 bn: Optional[int] = None,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C[b] = A[b] @ dense[b] for a shared-index-stream batch.

    ``dense`` is (B, K, N), or (K, N) to broadcast one operand across the
    batch.  Returns (B, M, N) in ``out_dtype``."""
    a = pad_empty_rows(a)
    if dense.dim() == 2:
        dense = dense.expand((a.batch,) + tuple(dense.shape))
    if dense.shape[0] != a.batch or dense.shape[1] != a.shape[2]:
        raise ValueError(f"spmm_batched: A {a.shape} x dense "
                         f"{tuple(dense.shape)}")
    return spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense.contiguous(),
                     out_dtype=out_dtype, bn=bn, scales=a.scales)


def flops(a: Union[BCSR, BatchedBCSR], n: int) -> int:
    """Useful FLOPs: 2 * nonzero-block elements * N.  For a BatchedBCSR,
    union positions holding an all-zero tile in one batch element are
    stream work, not useful FLOPs, and are not counted."""
    bm, bk = a.block
    if isinstance(a, BatchedBCSR):
        nz_blocks = int((a.blocks != 0).any(dim=-1).any(dim=-1).sum())
        return 2 * nz_blocks * bm * bk * n
    return 2 * int(a.nnzb) * bm * bk * n


def stream_row_stats(a: BatchedBCSR) -> dict:
    """Row statistics of a batched stream, as the kernel walks it: the
    block-row count ``gm``; ``nnzb_stream`` entries, of which
    ``nnzb_covered`` distinct coordinates (bucket pad entries repeat the
    last one) and ``nnzb_routed`` with a nonzero block in some batch; the
    entries of the longest row, of the last row, and the median of the
    other rows; ``zero_blocks``, the (batch, entry) blocks that are all
    zero, which the kernel stages and skips."""
    counts = a.indptr.cpu().long().diff()
    gn = a.grid_shape[1]
    coords = a.block_rows.cpu().long() * gn + a.block_cols.cpu().long()
    nonzero = (a.blocks.float() != 0).flatten(2).any(-1)     # (B, nnzb)
    return {"gm": int(counts.numel()), "nnzb_stream": a.nnzb,
            "nnzb_covered": int(coords.unique().numel()),
            "nnzb_routed": int(nonzero.any(0).sum()),
            "row_max": int(counts.max()), "row_last": int(counts[-1]),
            "row_median_others": (float(counts[:-1].median())
                                  if counts.numel() > 1 else 0.0),
            "zero_blocks": int((~nonzero).sum())}
