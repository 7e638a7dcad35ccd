"""Wrappers of the stencil CUDA kernels (``csrc/stencil.cu``): K6a
``stencil_2d`` and K6b ``stencil_3d``, the ports of the Pallas kernels of
the same names (repro/kernels/stencil/kernel.py), with their signatures
minus ``interpret``.

``grid_in`` carries the halo (interior + 2 * radius per dim); the result is
the interior in the grid's dtype (f32 or bf16).  Unlike the reference, the
interior need not be a multiple of the tile: the kernels bounds-check the
ragged edge.  A CPU tensor takes the plain version (``ref.stencil_ref``); a
CUDA tensor launches a kernel on the current stream or raises.  Each
wrapper counts its launches in ``.launches``.

K6b launches the march (``march_kernel``), compiled for the two 3-D tap
patterns of the repository's specs, where :func:`pattern_of` finds one;
any other 3-D spec launches the general kernel that K6a uses.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.stencils import StencilSpec, _box, _star
from repro_torch.kernels import build, tuning
from repro_torch.kernels.stencil.ref import stencil_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TAPS = 32
_MAX_SMEM = 48 * 1024
_P, _I = ctypes.c_void_p, ctypes.c_int

# The march's constants (``kRunX``, ``kRing``, ``kMarchThreads`` of
# ``csrc/stencil.cu``): consecutive x outputs of a thread, plane buffers in
# the shared-memory ring, most threads a block.
RUN_X, RING, MARCH_THREADS = 4, 4, 256
# The patterns the march is compiled for, by C code: the taps in the order
# ``core.stencils`` builds j3d27pt (``_box(3, 1)``) and j3d7pt
# (``_star(3, 1)``).
PATTERNS = {"box": (1, _box(3, 1)), "star": (2, _star(3, 1))}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``stencil.cu``, with its C interface typed (the
    march only where the build has it)."""
    lib.stencil_launch.argtypes = [_P, _P] + [_I] * 9 + [_P, _P, _I, _P]
    lib.stencil_launch.restype = ctypes.c_int
    if hasattr(lib, "stencil3d_march_launch"):
        lib.stencil3d_march_launch.argtypes = [_P, _P] + [_I] * 7 + [
            _P, _I, _P]
        lib.stencil3d_march_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("stencil"))


def pattern_of(spec: StencilSpec) -> Optional[str]:
    """The march pattern (``"box"``, ``"star"``) whose taps equal
    ``spec.offsets`` exactly, in order; None for any other spec, which
    takes the general kernel."""
    if spec.ndim != 3:
        return None
    offsets = tuple(tuple(o) for o in spec.offsets)
    for name, (_, taps) in PATTERNS.items():
        if offsets == taps:
            return name
    return None


def march_geometry(tile: Tuple[int, int, int],
                   itemsize: int = 4) -> Tuple[int, int]:
    """(threads, shared-memory bytes) of one march block at output tile
    (tz, ty, tx) on a grid of ``itemsize``-byte values: ceil(tx / RUN_X) x
    ty threads, and RING plane buffers of (ty + 2) rows, each ``RUN_X *
    ceil(tx / RUN_X) + 4`` values of the grid's type."""
    _, ty, tx = tile
    nthx = -(-tx // RUN_X)
    return nthx * ty, itemsize * RING * (ty + 2) * (RUN_X * nthx + 4)


def _check_grid(grid_in: torch.Tensor, interior, tile, what: str) -> None:
    if grid_in.dtype not in _DTYPE_CODE or not grid_in.is_contiguous():
        raise TypeError(f"{what}: needs a contiguous f32 or bf16 grid, got "
                        f"{grid_in.dtype}")
    if min(interior) < 1 or min(tile) < 1:
        raise ValueError(f"{what}: grid {tuple(grid_in.shape)} has no "
                         f"interior, or tile {tile} is empty")
    Z, Y = interior[0], interior[-2]
    if -(-Y // tile[-2]) > 65535 or -(-Z // tile[0]) > 65535:
        raise ValueError(f"{what}: grid of tiles out of range")


def _launch(grid_in: torch.Tensor, spec: StencilSpec,
            tile: Tuple[int, int, int], what: str,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """The general kernel on a 3-D view: a 2-D stencil is one plane with no
    z halo.  ``lib``: another build of ``stencil.cu`` (default: the
    tree's)."""
    r = spec.radius
    rz = r if spec.ndim == 3 else 0
    g = grid_in if spec.ndim == 3 else grid_in[None]
    Z, Y, X = g.shape[0] - 2 * rz, g.shape[1] - 2 * r, g.shape[2] - 2 * r
    tz, ty, tx = tile
    _check_grid(grid_in, (Z, Y, X), tile, what)
    if spec.points > _MAX_TAPS:
        raise ValueError(f"{what}: {spec.points} taps > {_MAX_TAPS}")
    sy, sx = ty + 2 * r, tx + 2 * r
    if 4 * (tz + 2 * rz) * sy * sx > _MAX_SMEM:
        raise ValueError(f"{what}: tile {tile} with its halo exceeds "
                         f"{_MAX_SMEM} bytes of shared memory")
    offs = [(0,) + tuple(o) if spec.ndim == 2 else tuple(o)
            for o in spec.offsets]
    delta = (ctypes.c_int * spec.points)(
        *[(dz * sy + dy) * sx + dx for dz, dy, dx in offs])
    coeff = (ctypes.c_float * spec.points)(*spec.coeffs_f32())
    out = torch.empty((Y, X) if spec.ndim == 2 else (Z, Y, X),
                      dtype=grid_in.dtype, device=grid_in.device)
    lib = lib or _lib()
    err = lib.stencil_launch(
        grid_in.data_ptr(), out.data_ptr(), Z, Y, X, rz, r, tz, ty, tx,
        spec.points, delta, coeff, _DTYPE_CODE[grid_in.dtype],
        torch.cuda.current_stream(grid_in.device).cuda_stream)
    build.check(lib, err, f"{what} launch")
    return out


def march(grid_in: torch.Tensor, spec: StencilSpec,
          tile: Tuple[int, int, int],
          lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """K6b's march on a CUDA grid whose spec :func:`pattern_of` matches, at
    output tile (tz, ty, tx): a block walks tz planes over a (ty, tx)
    footprint.  ``lib``: another build of ``stencil.cu`` (default: the
    tree's).  Raises where the tile does not fit a block."""
    name = pattern_of(spec)
    if name is None:
        raise ValueError(f"march: {spec.name} matches no compiled pattern")
    interior = tuple(s - 2 for s in grid_in.shape)
    tile = tuple(tile)
    _check_grid(grid_in, interior, tile, "stencil_3d")
    threads, smem = march_geometry(tile, grid_in.element_size())
    if threads > MARCH_THREADS or smem > _MAX_SMEM:
        raise ValueError(f"stencil_3d: tile {tile} needs {threads} threads "
                         f"and {smem} bytes of shared memory (at most "
                         f"{MARCH_THREADS}, {_MAX_SMEM})")
    code, _ = PATTERNS[name]
    coeff = (ctypes.c_float * spec.points)(*spec.coeffs_f32())
    out = torch.empty(interior, dtype=grid_in.dtype, device=grid_in.device)
    lib = lib or _lib()
    err = lib.stencil3d_march_launch(
        grid_in.data_ptr(), out.data_ptr(), *interior, *tile, code, coeff,
        _DTYPE_CODE[grid_in.dtype],
        torch.cuda.current_stream(grid_in.device).cuda_stream)
    build.check(lib, err, "stencil_3d launch")
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
    build.refuse_grad("stencil_2d", grid_in)
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
    (Z + 2r, Y + 2r, X + 2r) -> (Z, Y, X).  ``tile``: the output tile of
    one thread block, (tz, ty, tx); the march walks its tz planes one at a
    time (default: the cuda ``stencil3d`` row of ``kernels.tuning``, its
    ``general_tile`` for a spec that takes the general kernel)."""
    if spec.ndim != 3 or grid_in.dim() != 3:
        raise ValueError(f"stencil_3d: a 3-D spec and grid, got {spec.name} "
                         f"on {tuple(grid_in.shape)}")
    if grid_in.device.type == "cpu":
        return stencil_ref(grid_in, spec)
    build.refuse_grad("stencil_3d", grid_in)
    r = spec.radius
    interior = tuple(s - 2 * r for s in grid_in.shape)
    general = pattern_of(spec) is None
    tile = tuple(tile or tuning.stencil_tile(interior, grid_in.dtype,
                                             grid_in.device, general=general))
    if general:
        out = _launch(grid_in, spec, tile, "stencil_3d")
    else:
        out = march(grid_in, spec, tile)
    stencil_3d.launches += 1
    return out


stencil_2d.launches = 0
stencil_3d.launches = 0
