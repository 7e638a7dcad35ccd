"""Affine and indirect stream descriptors (``repro/core/streams.py``): the
software model of Occamy's SU streams.  An SU is programmed with up to four
(bound, stride) pairs and a base; thereafter it delivers the stream at FPU
rate.  Here the streams read and write flat tensors by gather and scatter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """<=4-D affine stream: ``addr(i0..ik) = base + sum_d i_d * stride_d``,
    in elements of the flattened operand, highest dimension first."""

    base: int
    bounds: Tuple[int, ...]
    strides: Tuple[int, ...]

    def __post_init__(self):
        if not 1 <= len(self.bounds) <= 4:
            raise ValueError("Occamy SUs support <=4-D streams")
        if len(self.bounds) != len(self.strides):
            raise ValueError("bounds and strides differ in length")

    @property
    def length(self) -> int:
        return int(np.prod(self.bounds))

    def offsets(self) -> np.ndarray:
        """Materialized address stream (host-side)."""
        grids = np.meshgrid(*[np.arange(b) for b in self.bounds],
                            indexing="ij")
        off = np.full(grids[0].shape, self.base, np.int64)
        for g, s in zip(grids, self.strides):
            off = off + g * s
        return off.reshape(-1)

    def read(self, flat: torch.Tensor) -> torch.Tensor:
        """The affine stream read (a gather)."""
        idx = torch.from_numpy(self.offsets()).to(flat.device)
        return flat.reshape(-1)[idx]

    @staticmethod
    def for_tensor(shape: Sequence[int],
                   order: Optional[Sequence[int]] = None) -> "StreamSpec":
        """Stream that walks ``shape`` in ``order`` (default: row-major)."""
        shape = tuple(shape)
        strides, acc = [], 1
        for s in reversed(shape):
            strides.append(acc)
            acc *= s
        strides = strides[::-1]
        order = tuple(order) if order is not None else tuple(range(len(shape)))
        return StreamSpec(base=0, bounds=tuple(shape[d] for d in order),
                          strides=tuple(strides[d] for d in order))


@dataclasses.dataclass(frozen=True)
class IndirectStream:
    """Indexed stream: ``addr(i) = base + idx[i] * stride`` (SU
    indirection); indices of any integer width are widened."""

    indices: torch.Tensor  # (n,)
    stride: int = 1
    base: int = 0

    def _addr(self) -> torch.Tensor:
        return self.base + self.indices.long() * self.stride

    def read(self, flat: torch.Tensor) -> torch.Tensor:
        return flat.reshape(-1)[self._addr()]

    def write(self, flat: torch.Tensor, values: torch.Tensor,
              accumulate: bool = True) -> torch.Tensor:
        """A new flat tensor with ``values`` added (or set) at the stream's
        addresses."""
        flat = flat.reshape(-1)
        if accumulate:
            return flat.index_add(0, self._addr(), values)
        return flat.index_copy(0, self._addr(), values)
