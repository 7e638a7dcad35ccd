"""Public SpMM API: BatchedBCSR container in, normalized kernel call out.

  * :func:`spmm`         -- one (M, K) BCSR matrix (a BatchedBCSR of batch 1)
    x (K, N) dense.
  * :func:`spmm_batched` -- BatchedBCSR (shared index stream, per-batch
    blocks) x (B, K, N) [or a broadcast (K, N)] dense.  The batch is a grid
    dimension of the kernel (the reference vmaps its kernel instead).

The N-tile defaults to the ``spmm`` row of ``kernels.tuning``.
``pad_empty_rows`` keeps the reference's stream contract (every block-row
appears); the kernel itself also writes zeros for an empty row.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import BatchedBCSR
from repro_torch.kernels.spmm.kernel import spmm_bcsr


def pad_empty_rows(a: BatchedBCSR) -> BatchedBCSR:
    """Ensure every block-row appears in the stream: one zero block at col
    0 for each empty row, stream kept (row, col)-sorted.  Host-side (numpy
    on the index stream); returns ``a`` itself when no row is empty."""
    gm = a.grid_shape[0]
    rows = a.block_rows.cpu().numpy()
    present = np.zeros(gm, bool)
    present[rows] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size == 0:
        return a
    cols = a.block_cols.cpu().numpy()
    rows = np.concatenate([rows, missing])
    cols = np.concatenate([cols, np.zeros_like(missing)])
    order = np.lexsort((cols, rows))
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=gm), out=indptr[1:])
    dev = a.blocks.device
    blocks = torch.cat(
        [a.blocks, a.blocks.new_zeros((a.batch, missing.size) + a.block)],
        dim=1)[:, torch.from_numpy(order).to(dev)]
    scales = None
    if a.scales is not None:
        # zero blocks dequantize to zero under any scale
        scales = torch.cat([a.scales, a.scales.new_ones(
            (a.batch, missing.size))], dim=1)[:, torch.from_numpy(order).to(dev)]
    return BatchedBCSR(indptr=torch.from_numpy(indptr).to(dev),
                       block_rows=torch.from_numpy(rows[order]).to(dev),
                       block_cols=torch.from_numpy(cols[order]).to(dev),
                       blocks=blocks.contiguous(), shape=a.shape,
                       block=a.block, scales=scales)


def spmm(a: BatchedBCSR, dense: torch.Tensor, *, bn: Optional[int] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ dense for one matrix: ``a`` of batch 1, ``dense`` (K, N).
    Returns (M, N)."""
    if a.batch != 1 or dense.dim() != 2:
        raise ValueError(f"spmm: one matrix (batch 1) x (K, N) dense, got "
                         f"batch {a.batch} x {tuple(dense.shape)}")
    return spmm_batched(a, dense[None], bn=bn, out_dtype=out_dtype)[0]


def spmm_batched(a: BatchedBCSR, dense: torch.Tensor, *,
                 bn: Optional[int] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C[b] = A[b] @ dense[b] for a shared-index-stream batch.

    ``dense`` is (B, K, N), or (K, N) to broadcast one operand across the
    batch.  Returns (B, M, N) in ``out_dtype`` (default: dense's dtype)."""
    a = pad_empty_rows(a)
    if dense.dim() == 2:
        dense = dense.expand((a.batch,) + tuple(dense.shape))
    if dense.shape[0] != a.batch or dense.shape[1] != a.shape[2]:
        raise ValueError(f"spmm_batched: A {a.shape} x dense "
                         f"{tuple(dense.shape)}")
    return spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense.contiguous(),
                     out_dtype=out_dtype, bn=bn, scales=a.scales)
