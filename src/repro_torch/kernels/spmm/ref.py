"""Plain PyTorch version of the batched BCSR SpMM (K2).

Computes exactly what the CUDA kernel computes -- per stream entry an f32
block product rounded to the output dtype, added to the row's accumulator
and rounded again, entries of a row taken in stream order -- so the CPU path
and the kernel agree up to the summation order inside one block product.
Used for CPU tensors, and by ``chip_smoke.py`` as the kernel's yardstick of
correctness on the card.
"""
from __future__ import annotations

import torch


def spmm_bcsr_ref(indptr: torch.Tensor, block_cols: torch.Tensor,
                  blocks: torch.Tensor, dense: torch.Tensor, *,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """C[b] = A[b] @ dense[b].  blocks (B, nnzb, bm, bk), dense (B, K, N)
    -> (B, gm * bm, N) in ``out_dtype``."""
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
        tiles = dense.reshape(B, -1, bk, N)[:, block_cols.long()]
        part = torch.matmul(blocks.float(), tiles.float()).to(out_dtype)
        # entries at the same depth of their rows hit distinct rows
        for j in range(int(counts.max())):
            sel = torch.nonzero(depth == j).squeeze(1)
            r = rows[sel]
            acc[:, r] = (acc[:, r] + part[:, sel].float()).to(out_dtype).float()
    return acc.to(out_dtype).reshape(B, gm * bm, N)
