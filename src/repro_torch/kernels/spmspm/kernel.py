"""Wrapper of the K5 CUDA kernel (``csrc/spmspm_ell.cu``): SpMSpM over
padded-ELL index streams, the port of the Pallas ``spmspm_ell``
(repro/kernels/spmspm/kernel.py), wide and with per-row ``a_scales``, with
its signature minus ``interpret``.

On the card a call buckets B's entries by (key, slab of output columns)
(:func:`bucket_columns`: a key-range pass read to the host -- the call's
one device sync -- then count, scan and scatter kernels), then runs the
row-wise product: one warp per (A row, slab) adds ``a * b`` for each of its
row's keys, in stream order, into the slab's columns.

A CPU tensor takes the plain version (``ref.spmspm_ell_ref``); a CUDA
tensor launches the kernels on the current stream or raises.
``spmspm_ell.launches`` counts launches of the product.  R and C need not
be multiples of the tiles: the kernel bounds-checks them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.spmspm.ref import spmspm_ell_ref

_A_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
           torch.float8_e5m2: 3, torch.int8: 4}
_B_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_ROWS = 32
# Shared memory of one product warp beyond its W floats: its staged keys.
_STAGE_BYTES = 512
# Largest bucket table (B's key span x slabs): 256 MB of counts and as much
# of offsets.
MAX_BUCKETS = 1 << 26


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib``, a build of ``spmspm_ell.cu``, with its C interface typed."""
    lib.spmspm_ell_key_range.argtypes = [_P, ctypes.c_longlong, _P, _P]
    lib.spmspm_ell_bucket.argtypes = [_P, _P] + [_I] * 6 + [_P] * 4
    lib.spmspm_ell_product.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    for fn in (lib.spmspm_ell_key_range, lib.spmspm_ell_bucket,
               lib.spmspm_ell_product):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("spmspm_ell"))


def product_smem_bytes(rows: int, width: int) -> int:
    """Shared memory of one product thread block: ``rows`` warps, each a
    ``width``-float accumulator and its staged keys."""
    return rows * (4 * width + _STAGE_BYTES)


def bucket_geometry(kmin: int, kmax: int, c: int,
                    width: int) -> Tuple[int, int]:
    """(key span, slabs) of B's bucket table: B's valid keys lie in
    [kmin, kmax] (kmax < kmin: B has none, span 0), and its ``c`` columns
    fall into ceil(c / width) slabs of ``width`` output columns.

    Raises ValueError on a negative key, or when span x slabs exceeds
    :data:`MAX_BUCKETS` (2^26: at the 4 slabs of an 8192-column B, keys
    spanning 16.7 M values).  The reference takes any int32 key; keys are
    column indices of A, so a larger span needs an inner dimension of
    over 16 M."""
    slabs = -(-c // width)
    if kmax < kmin:
        return 0, slabs
    if kmin < 0:
        raise ValueError(f"spmspm_ell: B holds a negative key ({kmin})")
    span = kmax - kmin + 1
    if span * slabs > MAX_BUCKETS:
        raise ValueError(f"spmspm_ell: B's keys span {span} values over "
                         f"{slabs} slabs, more than {MAX_BUCKETS} buckets")
    return span, slabs


class Buckets(NamedTuple):
    """B bucketed by (key - kmin, slab): bucket ``(k - kmin) * slabs + s``
    holds ``entries[offsets[b]:offsets[b + 1]]``, (column, f32 value bits)
    pairs."""
    kmin: int
    span: int
    width: int
    offsets: torch.Tensor
    entries: torch.Tensor


def bucket_columns(b_keys: torch.Tensor, b_vals: torch.Tensor,
                   width: int, lib: Optional[ctypes.CDLL] = None) -> Buckets:
    """B's (C, Lb) column streams bucketed on the card, for slabs of
    ``width`` output columns: the key range read to the host (one device
    sync), then the count, scan and scatter kernels (of ``lib``, a
    :func:`bind` build, default the in-tree one)."""
    lib = lib or _lib()
    dev = b_keys.device
    C, Lb = b_keys.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = torch.empty(2, dtype=torch.int32, device=dev)
    build.check(lib, lib.spmspm_ell_key_range(
        b_keys.data_ptr(), C * Lb, rng.data_ptr(), stream),
        "spmspm_ell key range")
    kmin, kmax = rng.tolist()
    span, slabs = bucket_geometry(kmin, kmax, C, width)
    kmin = kmin if span else 0
    counts = torch.empty(span * slabs, dtype=torch.int32, device=dev)
    offsets = torch.empty(span * slabs + 1, dtype=torch.int32, device=dev)
    entries = torch.empty((C * Lb, 2), dtype=torch.int32, device=dev)
    build.check(lib, lib.spmspm_ell_bucket(
        b_keys.data_ptr(), b_vals.data_ptr(), C, Lb, kmin, span, width,
        _B_CODE[b_vals.dtype], counts.data_ptr(), offsets.data_ptr(),
        entries.data_ptr(), stream), "spmspm_ell bucketing")
    return Buckets(kmin, span, width, offsets, entries)


def row_product(a_keys: torch.Tensor, a_vals: torch.Tensor,
                a_scales: Optional[torch.Tensor], buckets: Buckets, c: int,
                rows: int, lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """The row-wise product kernel (of ``lib``, default the in-tree build)
    over bucketed B: (R, c) f32, ``rows`` A rows (warps) a thread block.
    Counts no launch."""
    lib = lib or _lib()
    R, La = a_keys.shape
    out = torch.empty((R, c), dtype=torch.float32, device=a_keys.device)
    err = lib.spmspm_ell_product(
        a_keys.data_ptr(), a_vals.data_ptr(),
        None if a_scales is None else a_scales.data_ptr(),
        buckets.offsets.data_ptr(), buckets.entries.data_ptr(),
        out.data_ptr(), R, La, c, buckets.kmin, buckets.span, buckets.width,
        rows, _A_CODE[a_vals.dtype],
        torch.cuda.current_stream(a_keys.device).cuda_stream)
    build.check(lib, err, "spmspm_ell product")
    return out


def spmspm_ell(a_keys: torch.Tensor, a_vals: torch.Tensor,
               b_keys: torch.Tensor, b_vals: torch.Tensor, *,
               rt: Optional[int] = None, ct: Optional[int] = None,
               nt: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32,
               a_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[r, c] = sum over key matches of A's row r and B's column c.

    Args:
      a_keys / a_vals: (R, La) padded-ELL rows of A (int32 keys ascending,
        ``INVALID_KEY`` pads; values f32, bf16, or fp8 / int8 with scales).
      b_keys / b_vals: (C, Lb) padded-ELL *columns* of B (f32 or bf16),
        valid keys in [0, 2^31 - 1) spanning at most :data:`MAX_BUCKETS`
        / slabs values (:func:`bucket_geometry`).
      rt: A rows (one warp each) per thread block, 1..32; ``nt * ct``: the
        slab width W, the output columns one warp accumulates in shared
        memory (a multiple of 4).  Defaults: the cuda ``spmspm`` row of
        ``kernels.tuning``.  No value changes the result.
      a_scales: (R,) or (R, 1) f32 per-row dequant scales of narrow A.
    Returns:
      (R, C) f32.
    """
    if out_dtype != torch.float32:
        raise TypeError(f"spmspm_ell: the output is f32, not {out_dtype}")
    R, La = a_keys.shape
    C, Lb = b_keys.shape
    if a_vals.shape != a_keys.shape or b_vals.shape != b_keys.shape:
        raise ValueError("spmspm_ell: keys and values differ in shape")
    if a_scales is not None:
        a_scales = a_scales.reshape(R)
    if a_keys.device.type == "cpu":
        return spmspm_ell_ref(a_keys, a_vals, b_keys, b_vals,
                              a_scales=a_scales)
    build.refuse_grad("spmspm_ell", a_vals, b_vals, a_scales)
    trt, tct = tuning.spmspm_tiles(R, C, La, Lb, a_vals.dtype, a_keys.device)
    rt, ct = rt or trt, ct or tct
    nt = nt or tuning.spmspm_nt(C, ct, Lb, a_vals.dtype, a_keys.device)
    width = nt * ct
    dev = a_keys.device
    tensors = {"a_keys": a_keys, "a_vals": a_vals, "b_keys": b_keys,
               "b_vals": b_vals}
    if a_scales is not None:
        tensors["a_scales"] = a_scales
    for name, t in tensors.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"spmspm_ell: {name} must be contiguous on {dev}")
    if a_keys.dtype != torch.int32 or b_keys.dtype != torch.int32:
        raise TypeError("spmspm_ell: keys must be int32")
    if a_vals.dtype not in _A_CODE or b_vals.dtype not in _B_CODE \
            or (a_scales is not None and a_scales.dtype != torch.float32):
        raise TypeError(f"spmspm_ell: unsupported dtypes a={a_vals.dtype} "
                        f"b={b_vals.dtype}")
    if a_scales is None and a_vals.dtype not in _B_CODE:
        raise TypeError(f"spmspm_ell: {a_vals.dtype} A values need "
                        "a_scales")
    if not (1 <= rt <= _MAX_ROWS and nt >= 1 and ct >= 1 and width % 4 == 0
            and product_smem_bytes(rt, width) <= tuning.SMEM_BUDGET):
        raise ValueError(f"spmspm_ell: unsupported tiles rt={rt} ct={ct} "
                         f"nt={nt}")
    if R == 0 or C == 0:
        return torch.empty((R, C), dtype=torch.float32, device=dev)
    if La == 0 or Lb == 0:
        return torch.zeros((R, C), dtype=torch.float32, device=dev)
    out = row_product(a_keys, a_vals, a_scales,
                      bucket_columns(b_keys, b_vals, width), C, rt)
    spmspm_ell.launches += 1
    return out


spmspm_ell.launches = 0
