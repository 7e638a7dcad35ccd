"""Wrappers of the stencil CUDA kernel (``csrc/stencil.cu``): K6a
``stencil_2d`` and K6b ``stencil_3d``, the ports of the Pallas kernels of
the same names (repro/kernels/stencil/kernel.py), with their signatures
minus ``interpret``.

``grid_in`` carries the halo (interior + 2 * radius per dim); the result is
the interior in the grid's dtype (f32 or bf16).  Unlike the reference, the
interior need not be a multiple of the tile: the kernel bounds-checks the
ragged edge.  A CPU tensor takes the plain version (``ref.stencil_ref``); a
CUDA tensor launches the kernel on the current stream or raises.  Each
wrapper counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.stencils import StencilSpec
from repro_torch.kernels import build, tuning
from repro_torch.kernels.stencil.ref import stencil_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 32
_MAX_SMEM = 48 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("stencil")
    lib.stencil_launch.argtypes = [_P, _P] + [_I] * 9 + [_P, _P, _I, _P]
    lib.stencil_launch.restype = ctypes.c_int
    return lib


def _launch(grid_in: torch.Tensor, spec: StencilSpec,
            tile: Tuple[int, int, int], what: str) -> torch.Tensor:
    """Launch on a 3-D view: a 2-D stencil is one plane with no z halo."""
    r = spec.radius
    rz = r if spec.ndim == 3 else 0
    g = grid_in if spec.ndim == 3 else grid_in[None]
    Z, Y, X = g.shape[0] - 2 * rz, g.shape[1] - 2 * r, g.shape[2] - 2 * r
    tz, ty, tx = tile
    if grid_in.dtype not in _DTYPE_CODE or not grid_in.is_contiguous():
        raise TypeError(f"{what}: needs a contiguous f32 or bf16 grid, got "
                        f"{grid_in.dtype}")
    if min(Z, Y, X) < 1 or min(tile) < 1:
        raise ValueError(f"{what}: grid {tuple(grid_in.shape)} has no "
                         f"interior for radius {r}, or tile {tile} is empty")
    if spec.points > _MAX_TAPS:
        raise ValueError(f"{what}: {spec.points} taps > {_MAX_TAPS}")
    sy, sx = ty + 2 * r, tx + 2 * r
    if 4 * (tz + 2 * rz) * sy * sx > _MAX_SMEM:
        raise ValueError(f"{what}: tile {tile} with its halo exceeds "
                         f"{_MAX_SMEM} bytes of shared memory")
    if -(-Y // ty) > 65535 or -(-Z // tz) > 65535:
        raise ValueError(f"{what}: grid of tiles out of range")
    offs = [(0,) + tuple(o) if spec.ndim == 2 else tuple(o)
            for o in spec.offsets]
    delta = (ctypes.c_int * spec.points)(
        *[(dz * sy + dy) * sx + dx for dz, dy, dx in offs])
    coeff = (ctypes.c_float * spec.points)(*spec.coeffs_f32())
    out = torch.empty((Y, X) if spec.ndim == 2 else (Z, Y, X),
                      dtype=grid_in.dtype, device=grid_in.device)
    lib = _lib()
    err = lib.stencil_launch(
        grid_in.data_ptr(), out.data_ptr(), Z, Y, X, rz, r, tz, ty, tx,
        spec.points, delta, coeff, _DTYPE_CODE[grid_in.dtype],
        torch.cuda.current_stream(grid_in.device).cuda_stream)
    build.check(lib, err, f"{what} launch")
    return out


def stencil_2d(grid_in: torch.Tensor, spec: StencilSpec, *,
               tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Apply a 2-D ``spec`` to ``grid_in`` (H + 2r, W + 2r) -> (H, W).
    ``tile``: the output tile of one thread block (default: the cuda
    ``stencil2d`` row of ``kernels.tuning``)."""
    if spec.ndim != 2 or grid_in.dim() != 2:
        raise ValueError(f"stencil_2d: a 2-D spec and grid, got {spec.name} "
                         f"on {tuple(grid_in.shape)}")
    if grid_in.device.type == "cpu":
        return stencil_ref(grid_in, spec)
    r = spec.radius
    interior = tuple(s - 2 * r for s in grid_in.shape)
    th, tw = tile or tuning.stencil_tile(interior, grid_in.dtype,
                                         grid_in.device)
    out = _launch(grid_in, spec, (1, th, tw), "stencil_2d")
    stencil_2d.launches += 1
    return out


def stencil_3d(grid_in: torch.Tensor, spec: StencilSpec, *,
               tile: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Apply a 3-D ``spec`` (j3d7pt, j3d27pt) to ``grid_in``
    (Z + 2r, Y + 2r, X + 2r) -> (Z, Y, X)."""
    if spec.ndim != 3 or grid_in.dim() != 3:
        raise ValueError(f"stencil_3d: a 3-D spec and grid, got {spec.name} "
                         f"on {tuple(grid_in.shape)}")
    if grid_in.device.type == "cpu":
        return stencil_ref(grid_in, spec)
    r = spec.radius
    interior = tuple(s - 2 * r for s in grid_in.shape)
    tile = tile or tuning.stencil_tile(interior, grid_in.dtype,
                                       grid_in.device)
    out = _launch(grid_in, spec, tuple(tile), "stencil_3d")
    stencil_3d.launches += 1
    return out


stencil_2d.launches = 0
stencil_3d.launches = 0
