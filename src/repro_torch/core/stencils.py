"""Stencil specifications and their plain application (the port of
``repro/core/stencils.py``).

A stencil is a set of (offset, coefficient) taps; applying it at every
interior point is the gather-FMA chain Occamy's SUs stream.  The
coefficients come from the reference's numpy draw, so they are the same
doubles.  The reference multiplies a tap by ``c`` as a weak-typed f32, so
the plain version here (and the CUDA kernel, ``kernels/stencil``) round
``c`` to f32 once and compute ``acc = acc + c * tap`` in f32 -- product
rounded, then sum rounded, taps in ``offsets`` order.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    name: str
    ndim: int
    offsets: Tuple[Tuple[int, ...], ...]  # taps, each of length ndim
    coeffs: Tuple[float, ...]

    @property
    def points(self) -> int:
        return len(self.offsets)

    @property
    def radius(self) -> int:
        return max(max(abs(o) for o in off) for off in self.offsets)

    def flops_per_point(self) -> int:
        # one multiply + one add per tap
        return 2 * self.points

    def coeffs_f32(self) -> Tuple[float, ...]:
        """The coefficients rounded to f32 once, as the reference's
        weak-typed multiply uses them."""
        return tuple(float(np.float32(c)) for c in self.coeffs)


def _star(ndim: int, radius: int = 1) -> Tuple[Tuple[int, ...], ...]:
    offs = [tuple([0] * ndim)]
    for d in range(ndim):
        for r in range(1, radius + 1):
            for s in (-r, r):
                o = [0] * ndim
                o[d] = s
                offs.append(tuple(o))
    return tuple(offs)


def _box(ndim: int, radius: int = 1) -> Tuple[Tuple[int, ...], ...]:
    return tuple(itertools.product(range(-radius, radius + 1), repeat=ndim))


def _mk(name, ndim, offsets):
    rng = np.random.default_rng(len(name) * 7 + ndim)  # fixed taps
    coeffs = tuple((rng.random(len(offsets)) * 0.2 + 0.01).tolist())
    return StencilSpec(name=name, ndim=ndim, offsets=offsets, coeffs=coeffs)


STENCILS: Dict[str, StencilSpec] = {
    "j2d5pt": _mk("j2d5pt", 2, _star(2, 1)),
    "j2d9pt": _mk("j2d9pt", 2, _box(2, 1)),
    "j2d9pt-gol": _mk("j2d9pt-gol", 2, _star(2, 2)),  # star radius-2 (9 taps)
    "j3d7pt": _mk("j3d7pt", 3, _star(3, 1)),
    "j3d27pt": _mk("j3d27pt", 3, _box(3, 1)),
}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def apply_reference(spec: StencilSpec, grid: torch.Tensor) -> torch.Tensor:
    """Shifted-slice application; ``grid`` carries the halo, the result is
    the interior (grid.shape - 2 * radius per dim) in the grid's dtype."""
    r = spec.radius
    out_shape = tuple(s - 2 * r for s in grid.shape)
    acc = torch.zeros(out_shape, dtype=_acc_dtype(grid.dtype),
                      device=grid.device)
    for off, c in zip(spec.offsets, spec.coeffs_f32()):
        sl = tuple(slice(r + o, r + o + n) for o, n in zip(off, out_shape))
        acc = acc + c * grid[sl].to(acc.dtype)
    return acc.to(grid.dtype)


def apply_gather_baseline(spec: StencilSpec, grid: torch.Tensor
                          ) -> torch.Tensor:
    """The no-SU baseline: explicit index computation and a gather per tap
    (the paper's scalar RISC-V baseline).  As in the reference, the product
    is taken in the grid's dtype (a bf16 grid rounds ``c`` and ``c * tap``
    to bf16) before the f32 sum."""
    r = spec.radius
    out_shape = tuple(s - 2 * r for s in grid.shape)
    grid = grid.contiguous()
    flat = grid.reshape(-1)
    strides = grid.stride()
    mesh = torch.meshgrid(*[torch.arange(r, r + n, device=grid.device)
                            for n in out_shape], indexing="ij")
    base = sum(m * s for m, s in zip(mesh, strides))
    acc = torch.zeros(out_shape, dtype=_acc_dtype(grid.dtype),
                      device=grid.device)
    for off, c in zip(spec.offsets, spec.coeffs_f32()):
        delta = sum(o * s for o, s in zip(off, strides))
        tap = flat[(base + delta).reshape(-1)].reshape(out_shape)
        acc = acc + (torch.tensor(c, dtype=grid.dtype) * tap).to(acc.dtype)
    return acc.to(grid.dtype)
