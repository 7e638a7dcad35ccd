"""Sparse containers, converters and generators of the port
(``repro/core/formats.py``).

* ``CSR`` -- element-granular CSR, the reference format.
* ``BCSR`` -- block CSR as a flattened, (row, col)-sorted block stream:
  ``blocks[i]`` is the i-th nonzero (bm, bk) tile, ``block_rows[i]`` /
  ``block_cols[i]`` its block coordinates, ``indptr[r]:indptr[r+1]``
  block-row ``r``'s slice -- the row pointers the SpMM kernel walks.
* ``BatchedBCSR`` -- a batch of BCSR matrices sharing ONE index stream (the
  union pattern) with per-batch block values ``(B, nnzb, bm, bk)``.
* ``SortedCOO`` -- a sorted ``row * n_cols + col`` key stream padded with
  ``INVALID_KEY`` past ``count``: the SU intersection / union operand.

Narrow (fp8 / int8) block values carry per-block f32 ``scales`` (BlockQuant,
``core.precision``): block ``i`` dequantizes as ``blocks[i].float() *
scales[i]``.  Index arrays are int32 tensors on the blocks' device.

The converters take a numpy array or a tensor.  A tensor stays where it
lies unless ``device=`` says otherwise; a numpy array goes to ``device``,
the card by default.  The numpy generators are copies of the reference's,
so one seed gives the same matrix on both sides.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import as_tensor
from repro_torch.core.precision import (dequantize_blocks, is_narrow,
                                        quantize_blocks)

INVALID_KEY = np.int32(2**31 - 1)


def _check_quant_consistency(cls_name: str, blocks, scales, lead_ndim: int):
    """Narrow values without scales would be read as magnitudes, and
    mis-shaped scales would broadcast wrongly: both raise here."""
    if scales is not None:
        want = tuple(blocks.shape[:lead_ndim])
        if tuple(scales.shape) != want:
            raise ValueError(
                f"{cls_name}: scales shape {tuple(scales.shape)} does not "
                f"match blocks {tuple(blocks.shape)} (expected per-block "
                f"scales of shape {want})")
        if scales.dtype != torch.float32:
            raise ValueError(
                f"{cls_name}: scales must be float32, got {scales.dtype}")
    elif is_narrow(blocks.dtype):
        raise ValueError(
            f"{cls_name}: narrow block values ({blocks.dtype}, shape "
            f"{tuple(blocks.shape)}) require per-block scales; quantize via "
            ".quantize()/core.precision.quantize_blocks instead of casting "
            "raw values")


@dataclasses.dataclass(frozen=True)
class CSR:
    """Element-granular CSR (column ids sorted within each row)."""

    indptr: torch.Tensor   # (n_rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    values: torch.Tensor   # (nnz,)
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def todense(self) -> torch.Tensor:
        n_rows, _ = self.shape
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=self.values.device),
            self.indptr.long().diff())
        out = self.values.new_zeros(self.shape)
        out.index_put_((rows, self.indices.long()), self.values,
                       accumulate=True)
        return out


@dataclasses.dataclass(frozen=True)
class BCSR:
    """Block CSR as a flattened (row, col)-sorted block stream."""

    indptr: torch.Tensor      # (n_brows + 1,) int32
    block_rows: torch.Tensor  # (nnzb,) int32
    block_cols: torch.Tensor  # (nnzb,) int32
    blocks: torch.Tensor      # (nnzb, bm, bk)
    shape: Tuple[int, int]
    block: Tuple[int, int]
    scales: Optional[torch.Tensor] = None  # (nnzb,) f32 per-block scales

    def __post_init__(self):
        _check_quant_consistency("BCSR", self.blocks, self.scales, 1)

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return (self.shape[0] // self.block[0], self.shape[1] // self.block[1])

    def quantize(self, dtype, *, rounding: str = "nearest", seed: int = 0,
                 noise=None) -> "BCSR":
        """Per-block-scaled narrow copy (same index stream)."""
        q, s = quantize_blocks(self.blocks, dtype, rounding=rounding,
                               seed=seed, noise=noise)
        return dataclasses.replace(self, blocks=q, scales=s)

    def dequantize(self) -> "BCSR":
        """f32 copy with the scales folded into the block values."""
        if self.scales is None:
            return self
        return dataclasses.replace(
            self, blocks=dequantize_blocks(self.blocks, self.scales),
            scales=None)

    def todense(self) -> torch.Tensor:
        """(M, K) dense; repeated coordinates accumulate."""
        if self.scales is not None:
            return self.dequantize().todense()
        bm, bk = self.block
        gm, gn = self.grid_shape
        dense = self.blocks.new_zeros((gm, gn, bm, bk))
        dense.index_put_((self.block_rows.long(), self.block_cols.long()),
                         self.blocks, accumulate=True)
        return dense.permute(0, 2, 1, 3).reshape(self.shape)

    def density(self) -> float:
        gm, gn = self.grid_shape
        return self.nnzb / float(gm * gn)


@dataclasses.dataclass(frozen=True)
class BatchedBCSR:
    """A batch of BCSR matrices sharing one (row, col)-sorted index stream.

    Matrices whose pattern is a subset of the union hold zero blocks at the
    extra positions."""

    indptr: torch.Tensor      # (n_brows + 1,) int32 -- shared across the batch
    block_rows: torch.Tensor  # (nnzb,) int32 -- shared
    block_cols: torch.Tensor  # (nnzb,) int32 -- shared
    blocks: torch.Tensor      # (B, nnzb, bm, bk)
    shape: Tuple[int, int, int]   # (B, M, K)
    block: Tuple[int, int]
    scales: Optional[torch.Tensor] = None  # (B, nnzb) f32 per-block scales

    def __post_init__(self):
        _check_quant_consistency("BatchedBCSR", self.blocks, self.scales, 2)

    @property
    def batch(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[1]

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return (self.shape[1] // self.block[0], self.shape[2] // self.block[1])

    def __getitem__(self, i: int) -> BCSR:
        """Batch element ``i`` as a plain BCSR view."""
        return BCSR(indptr=self.indptr, block_rows=self.block_rows,
                    block_cols=self.block_cols, blocks=self.blocks[i],
                    shape=self.shape[1:], block=self.block,
                    scales=None if self.scales is None else self.scales[i])

    def quantize(self, dtype, *, rounding: str = "nearest", seed: int = 0,
                 noise=None) -> "BatchedBCSR":
        """Per-block-scaled narrow copy (same shared index stream)."""
        q, s = quantize_blocks(self.blocks, dtype, rounding=rounding,
                               seed=seed, noise=noise)
        return dataclasses.replace(self, blocks=q, scales=s)

    def dequantize(self) -> "BatchedBCSR":
        """f32 copy with the scales folded into the block values."""
        if self.scales is None:
            return self
        return dataclasses.replace(
            self, blocks=dequantize_blocks(self.blocks, self.scales),
            scales=None)

    def with_capacity(self, nnzb_cap: int) -> "BatchedBCSR":
        """Pad the shared index stream to exactly ``nnzb_cap`` entries.

        Pad entries repeat the *last* entry's (row, col) with all-zero
        blocks (scale 1.0), so the stream stays sorted, every block-row that
        appeared still appears, and the product is unchanged.  Host-side:
        reads the index stream back to numpy."""
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
        if self.scales is not None:
            return self.dequantize().todense()
        bm, bk = self.block
        gm, gn = self.grid_shape
        B = self.batch
        dense = self.blocks.new_zeros((B, gm, gn, bm, bk))
        b_idx = torch.arange(B, device=self.blocks.device)[:, None]
        dense.index_put_((b_idx, self.block_rows.long()[None],
                          self.block_cols.long()[None]), self.blocks,
                         accumulate=True)
        return dense.permute(0, 1, 3, 2, 4).reshape(self.shape)

    def density(self) -> float:
        gm, gn = self.grid_shape
        return self.nnzb / float(gm * gn)


@dataclasses.dataclass(frozen=True)
class SortedCOO:
    """Sorted coordinate stream: ``keys = row * n_cols + col`` ascending,
    values aligned, slots past ``count`` hold ``INVALID_KEY``."""

    keys: torch.Tensor    # (capacity,) int32, sorted; INVALID-padded
    values: torch.Tensor  # (capacity,)
    count: torch.Tensor   # () int32
    shape: Tuple[int, int]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def todense(self) -> torch.Tensor:
        n_rows, n_cols = self.shape
        valid = torch.arange(self.capacity, device=self.keys.device) \
            < self.count
        keys = torch.where(valid, self.keys, 0).long()
        vals = torch.where(valid, self.values, 0)
        out = self.values.new_zeros(n_rows * n_cols)
        out.index_add_(0, keys, vals)
        return out.reshape(self.shape)


# ---------------------------------------------------------------------------
# Converters: containers from a dense matrix (numpy array or tensor).
# ---------------------------------------------------------------------------

def csr_from_dense(dense, *, device=None) -> CSR:
    d = as_tensor(dense, device)
    mask = d != 0
    indptr = torch.zeros(d.shape[0] + 1, dtype=torch.int32, device=d.device)
    indptr[1:] = mask.sum(1).cumsum(0)
    rows, cols = torch.nonzero(mask, as_tuple=True)
    return CSR(indptr=indptr, indices=cols.to(torch.int32),
               values=d[rows, cols], shape=tuple(d.shape))


def _block_tiles(d: torch.Tensor, block: Tuple[int, int]):
    *lead, m, n = d.shape
    bm, bn = block
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(d.shape)} not divisible by block "
                         f"{block}")
    tiles = d.reshape(*lead, m // bm, bm, n // bn, bn).transpose(-3, -2)
    nz = tiles.abs().sum(dim=(-2, -1)) != 0
    return tiles, nz


def _index_stream(nz: torch.Tensor):
    """(gm, gn) nonzero-block mask -> indptr, rows, cols (row-major)."""
    rows, cols = torch.nonzero(nz, as_tuple=True)
    indptr = torch.zeros(nz.shape[0] + 1, dtype=torch.int32, device=nz.device)
    indptr[1:] = nz.sum(1).cumsum(0)
    return indptr, rows, cols


def bcsr_from_dense(dense, block: Tuple[int, int], *, device=None) -> BCSR:
    d = as_tensor(dense, device)
    tiles, nz = _block_tiles(d, block)
    indptr, rows, cols = _index_stream(nz)
    return BCSR(indptr=indptr, block_rows=rows.to(torch.int32),
                block_cols=cols.to(torch.int32),
                blocks=tiles[rows, cols].contiguous(), shape=tuple(d.shape),
                block=tuple(block))


def batched_bcsr_from_dense(dense, block: Tuple[int, int], *,
                            device=None) -> BatchedBCSR:
    """(B, M, K) dense stack -> BatchedBCSR over the union block pattern;
    blocks zero in one matrix are stored as zero tiles."""
    d = as_tensor(dense, device)
    if d.dim() != 3:
        raise ValueError(f"batched_bcsr_from_dense: (B, M, K), got "
                         f"{tuple(d.shape)}")
    tiles, nz = _block_tiles(d, block)
    indptr, rows, cols = _index_stream(nz.any(dim=0))
    return BatchedBCSR(indptr=indptr, block_rows=rows.to(torch.int32),
                       block_cols=cols.to(torch.int32),
                       blocks=tiles[:, rows, cols].contiguous(),
                       shape=tuple(d.shape), block=tuple(block))


def coo_from_dense(dense, capacity: Optional[int] = None, *,
                   device=None) -> SortedCOO:
    d = as_tensor(dense, device)
    n_rows, n_cols = d.shape
    rows, cols = torch.nonzero(d, as_tuple=True)   # row-major: keys sorted
    n = rows.numel()
    cap = capacity or n
    if cap < n:
        raise ValueError(f"coo_from_dense: capacity {cap} < nnz {n}")
    keys = torch.full((cap,), int(INVALID_KEY), dtype=torch.int32,
                      device=d.device)
    vals = d.new_zeros(cap)
    keys[:n] = (rows * n_cols + cols).to(torch.int32)
    vals[:n] = d[rows, cols]
    return SortedCOO(keys=keys, values=vals,
                     count=torch.tensor(n, dtype=torch.int32,
                                        device=d.device),
                     shape=(n_rows, n_cols))


# ---------------------------------------------------------------------------
# Generators (numpy, copies of the reference's): synthetic stand-ins for the
# paper's SuiteSparse set.
# ---------------------------------------------------------------------------

def random_dense_sparse(rng: np.random.Generator, shape, density: float,
                        dtype=np.float32) -> np.ndarray:
    """Uniform-random sparsity (the paper's 1 % random right matrices)."""
    mask = rng.random(shape) < density
    vals = rng.standard_normal(shape).astype(dtype)
    return np.where(mask, vals, 0).astype(dtype)


def banded_sparse(rng: np.random.Generator, shape, bandwidth: int,
                  dtype=np.float32) -> np.ndarray:
    """Banded matrix (stencil-like structure; FEM/FD matrices)."""
    m, n = shape
    i = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    mask = np.abs(i - j) <= bandwidth
    vals = rng.standard_normal(shape).astype(dtype)
    return np.where(mask, vals, 0).astype(dtype)


def powerlaw_sparse(rng: np.random.Generator, shape, density: float,
                    alpha: float = 1.5, dtype=np.float32) -> np.ndarray:
    """Power-law row degrees (graph adjacency-like; heavy row imbalance)."""
    m, n = shape
    target = int(density * m * n)
    weights = (np.arange(1, m + 1, dtype=np.float64)) ** (-alpha)
    weights /= weights.sum()
    row_nnz = np.minimum(rng.multinomial(target, weights), n)
    out = np.zeros(shape, dtype)
    for r in range(m):
        k = int(row_nnz[r])
        if k:
            cols = rng.choice(n, size=k, replace=False)
            out[r, cols] = rng.standard_normal(k).astype(dtype)
    return out


def block_sparse_mask(rng: np.random.Generator, grid_shape,
                      density: float) -> np.ndarray:
    """Random block-level mask (for generating BCSR streams directly)."""
    return rng.random(grid_shape) < density
