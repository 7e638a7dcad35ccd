"""Wrapper of the K5 CUDA kernel (``csrc/spmspm_ell.cu``): SpMSpM over
padded-ELL index streams, the port of the Pallas ``spmspm_ell``
(repro/kernels/spmspm/kernel.py), wide and with per-row ``a_scales``, with
its signature minus ``interpret``.

A CPU tensor takes the plain version (``ref.spmspm_ell_ref``); a CUDA
tensor launches the kernel on the current stream or raises.
``spmspm_ell.launches`` counts launches.  R and C need not be multiples of
the tiles: the kernel bounds-checks them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.spmspm.ref import spmspm_ell_ref

_A_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
           torch.float8_e5m2: 3, torch.int8: 4}
_B_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_MAX_ROWS = 32
_SMEM_BUDGET = 232448


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("spmspm_ell")
    lib.spmspm_ell_launch.argtypes = [_P] * 6 + [_I] * 10 + [_P]
    lib.spmspm_ell_launch.restype = ctypes.c_int
    return lib


def spmspm_ell(a_keys: torch.Tensor, a_vals: torch.Tensor,
               b_keys: torch.Tensor, b_vals: torch.Tensor, *,
               rt: Optional[int] = None, ct: Optional[int] = None,
               nt: Optional[int] = None, kt: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32,
               a_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[r, c] = sum over key matches of A's row r and B's column c.

    Args:
      a_keys / a_vals: (R, La) padded-ELL rows of A (int32 keys ascending,
        ``INVALID_KEY`` pads; values f32, bf16, or fp8 / int8 with scales).
      b_keys / b_vals: (C, Lb) padded-ELL *columns* of B (f32 or bf16).
      rt: A rows per thread block; ct: threads per block (a multiple of
        32; each warp takes one output column at a time); nt: column tiles
        of ``ct`` per block; kt: key chunk of the shared-memory rows.
        Defaults: the cuda ``spmspm`` row of ``kernels.tuning``.  No value
        changes the result.
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
    trt, tct = tuning.spmspm_tiles(R, C, La, Lb, a_vals.dtype, a_keys.device)
    rt, ct = rt or trt, ct or tct
    nt = nt or tuning.spmspm_nt(C, ct, Lb, a_vals.dtype, a_keys.device)
    kt = kt or tuning.spmspm_key_chunk(a_vals.dtype, a_keys.device)
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
    smem = 4 * rt * kt + 4 * rt * (kt // 32) + 4 * nt * ct
    if not (1 <= rt <= _MAX_ROWS and ct % 32 == 0 and 32 <= ct <= 1024
            and nt >= 1 and kt >= 32 and kt % 32 == 0
            and smem <= _SMEM_BUDGET and -(-C // (nt * ct)) <= 65535):
        raise ValueError(f"spmspm_ell: unsupported tiles rt={rt} ct={ct} "
                         f"nt={nt} kt={kt}")
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    if R == 0 or C == 0:
        return out
    if La == 0 or Lb == 0:
        return out.zero_()
    lib = _lib()
    err = lib.spmspm_ell_launch(
        a_keys.data_ptr(), a_vals.data_ptr(),
        None if a_scales is None else a_scales.data_ptr(),
        b_keys.data_ptr(), b_vals.data_ptr(), out.data_ptr(),
        R, La, C, Lb, rt, ct, nt * ct, kt, _A_CODE[a_vals.dtype],
        _B_CODE[b_vals.dtype], torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "spmspm_ell launch")
    spmspm_ell.launches += 1
    return out


spmspm_ell.launches = 0
