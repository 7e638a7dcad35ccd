"""Plain PyTorch version of the batched BCSR SpMM (K2, and K2q with scales).

Computes exactly what the CUDA kernel computes -- per stream entry an f32
block product rounded to the output dtype, added to the row's accumulator
and rounded again, entries of a row taken in stream order -- so the CPU path
and the kernel agree up to the summation order inside one block product.
Narrow blocks are first dequantized on the host as ``values.float() *
scale``, the value the kernel stages.  Used for CPU tensors, and by
``chip_smoke.py`` as the kernel's yardstick of correctness on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.precision import dequantize_blocks


def spmm_bcsr_ref(indptr: torch.Tensor, block_cols: torch.Tensor,
                  blocks: torch.Tensor, dense: torch.Tensor, *,
                  out_dtype: torch.dtype,
                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[b] = A[b] @ dense[b].  blocks (B, nnzb, bm, bk), dense (B, K, N),
    scales (B, nnzb) for narrow blocks -> (B, gm * bm, N) in ``out_dtype``.
    Entries are taken one depth of their rows at a time (entries at the
    same depth hit distinct rows), so the working set is one (gm, bk, N)
    slice of dense, not one per stream entry."""
    if scales is not None:
        blocks = dequantize_blocks(blocks, scales)
    B, nnzb, bm, bk = blocks.shape
    N = dense.shape[-1]
    gm = indptr.numel() - 1
    dev = dense.device
    acc = torch.zeros((B, gm, bm, N), dtype=torch.float32, device=dev)
    if nnzb:
        indptr = indptr.long()
        counts = indptr.diff()
        rows = torch.repeat_interleave(torch.arange(gm, device=dev), counts)
        depth = torch.arange(nnzb, device=dev) - indptr[rows]
        tiles = dense.reshape(B, -1, bk, N)
        cols = block_cols.long()
        for j in range(int(counts.max())):
            sel = torch.nonzero(depth == j).squeeze(1)
            r = rows[sel]
            part = torch.matmul(blocks[:, sel].float(),
                                tiles[:, cols[sel]].float()).to(out_dtype)
            acc[:, r] = (acc[:, r] + part.float()).to(out_dtype).float()
    return acc.to(out_dtype).reshape(B, gm * bm, N)
