"""Sparse containers of the port: the batched BCSR block stream.

``BatchedBCSR`` is a batch of BCSR matrices sharing ONE index stream: the
union block pattern (``indptr`` / ``block_rows`` / ``block_cols``) once, and
per-batch block values ``(B, nnzb, bm, bk)``.  The stream is (row, col)
sorted and ``indptr[r]:indptr[r+1]`` is block-row ``r``'s slice of it -- the
row pointers the SpMM kernel walks.  Index arrays are int32 tensors on the
same device as the blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BatchedBCSR:
    """A batch of BCSR matrices sharing one (row, col)-sorted index stream.

    ``scales`` (per-block f32 dequant scales of narrow blocks) is carried as
    in the reference container, but no kernel of the port takes it yet."""

    indptr: torch.Tensor      # (n_brows + 1,) int32 -- shared across the batch
    block_rows: torch.Tensor  # (nnzb,) int32 -- shared
    block_cols: torch.Tensor  # (nnzb,) int32 -- shared
    blocks: torch.Tensor      # (B, nnzb, bm, bk)
    shape: Tuple[int, int, int]   # (B, M, K)
    block: Tuple[int, int]
    scales: Optional[torch.Tensor] = None  # (B, nnzb) f32 per-block scales

    def __post_init__(self):
        if self.scales is not None and (
                tuple(self.scales.shape) != tuple(self.blocks.shape[:2])
                or self.scales.dtype != torch.float32):
            raise ValueError(
                f"BatchedBCSR: scales {tuple(self.scales.shape)} "
                f"{self.scales.dtype} must be f32 of shape "
                f"{tuple(self.blocks.shape[:2])}")

    @property
    def batch(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[1]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return (self.shape[1] // self.block[0], self.shape[2] // self.block[1])

    def with_capacity(self, nnzb_cap: int) -> "BatchedBCSR":
        """Pad the shared index stream to exactly ``nnzb_cap`` entries.

        Pad entries repeat the *last* entry's (row, col) with all-zero
        blocks, so the stream stays sorted, every block-row that appeared
        still appears, and the product is unchanged (zero blocks add zero).
        Host-side: reads the index stream back to numpy."""
        nnzb = self.nnzb
        if nnzb_cap < nnzb:
            raise ValueError(
                f"with_capacity({nnzb_cap}): stream already holds {nnzb} "
                "blocks; capacity can only grow")
        if nnzb_cap == nnzb:
            return self
        if nnzb == 0:
            raise ValueError("with_capacity: cannot pad an empty stream "
                             "(no coordinates to repeat)")
        pad = nnzb_cap - nnzb
        rows = self.block_rows.cpu().numpy()
        cols = self.block_cols.cpu().numpy()
        last_r = int(rows[-1])
        rows = np.concatenate([rows, np.full(pad, last_r, np.int32)])
        cols = np.concatenate([cols, np.full(pad, int(cols[-1]), np.int32)])
        indptr = self.indptr.cpu().numpy().copy()
        indptr[last_r + 1:] += pad
        dev = self.blocks.device
        blocks = torch.cat(
            [self.blocks,
             self.blocks.new_zeros((self.batch, pad) + tuple(self.block))],
            dim=1)
        scales = self.scales
        if scales is not None:
            scales = torch.cat(
                [scales, scales.new_ones((self.batch, pad))], dim=1)
        return BatchedBCSR(indptr=torch.from_numpy(indptr).to(dev),
                           block_rows=torch.from_numpy(rows).to(dev),
                           block_cols=torch.from_numpy(cols).to(dev),
                           blocks=blocks, shape=self.shape, block=self.block,
                           scales=scales)

    def todense(self) -> torch.Tensor:
        """(B, M, K) dense stack; repeated coordinates accumulate."""
        blocks = self.blocks
        if self.scales is not None:
            blocks = blocks.float() * self.scales[:, :, None, None]
        bm, bk = self.block
        gm, gn = self.grid_shape
        B = self.batch
        dense = blocks.new_zeros((B, gm, gn, bm, bk))
        b_idx = torch.arange(B, device=blocks.device)[:, None]
        dense.index_put_((b_idx, self.block_rows.long()[None],
                          self.block_cols.long()[None]), blocks,
                         accumulate=True)
        return dense.permute(0, 1, 3, 2, 4).reshape(self.shape)
