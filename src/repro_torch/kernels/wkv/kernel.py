"""Wrappers of the WKV CUDA kernels: K7 (``csrc/wkv.cu``), the port of the
Pallas kernel ``wkv_pallas`` (repro/kernels/wkv/kernel.py), with its
signature minus ``interpret`` and plus ``return_state``; and W1
(``csrc/wkv_step.cu``, :func:`wkv_step`), the one-token decode step, which
has no Pallas counterpart.

r, k, v, w_log: (B, T, nh, hd) with T a multiple of ``chunk`` (``ops``
pads); u: (nh, hd).  Returns y (B, T, nh, hd) f32 and, with
``return_state``, the final (B, nh, hd, hd) f32 state as well.  A CPU
tensor takes the plain version (``ref.wkv_chunked_plain``); a CUDA tensor
launches the kernel on the current stream or raises.  On the card r, k, v
share one dtype (f32 or bf16), w_log is f32 or that dtype, u is f32, hd is
64, ``chunk`` is ``tuning.WKV_CHUNK`` (128), and r, k, v, w_log start on 16
bytes.  Launches are counted in ``wkv_kernel.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.wkv.ref import wkv_chunked_plain, wkv_step_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIM = 64
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("wkv")
    lib.wkv_launch.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    lib.wkv_launch.restype = ctypes.c_int
    return lib


def _check_cuda(r, k, v, w_log, u, chunk: int) -> None:
    B, T, nh, hd = r.shape
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv_kernel: tensors on {dev}; the kernel runs on "
                         "a CUDA device, the plain version on the CPU")
    if any(x.device != dev for x in (k, v, w_log, u)):
        raise ValueError("wkv_kernel: inputs on different devices")
    if r.dtype not in _DTYPE_CODE or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv_kernel: r, k, v must share f32 or bf16, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w_log.dtype not in (torch.float32, r.dtype) \
            or u.dtype != torch.float32:
        raise TypeError(f"wkv_kernel: w_log f32 or r's dtype, and u f32, "
                        f"got {w_log.dtype}, {u.dtype}")
    if hd != HEAD_DIM:
        raise ValueError(f"wkv_kernel: head dim {hd}; the kernel takes "
                         f"{HEAD_DIM}")
    if chunk != tuning.WKV_CHUNK:
        raise ValueError(f"wkv_kernel: chunk {chunk}; the kernel takes "
                         f"{tuning.WKV_CHUNK}")
    if not all(x.is_contiguous() for x in (r, k, v, w_log, u)):
        raise ValueError("wkv_kernel: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (r, k, v, w_log)):
        raise ValueError("wkv_kernel: r, k, v and w_log must be 16-byte "
                         "aligned (the kernel loads 16-byte groups)")


def wkv_kernel(r, k, v, w_log, u, *, chunk: int = 128,
               return_state: bool = False):
    """y (and the final state with ``return_state``) of the chunked WKV
    recurrence; see the module docstring."""
    B, T, nh, hd = r.shape
    if any(tuple(x.shape) != (B, T, nh, hd) for x in (k, v, w_log)) \
            or tuple(u.shape) != (nh, hd):
        raise ValueError(f"wkv_kernel: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, w_log "
                         f"{tuple(w_log.shape)}, u {tuple(u.shape)}")
    if T < 1 or T % chunk:
        raise ValueError(f"wkv_kernel: T={T} is not a multiple of chunk "
                         f"{chunk} (ops pads)")
    if r.device.type == "cpu":
        y, s = wkv_chunked_plain(r, k, v, w_log, u, chunk)
        return (y, s) if return_state else y
    _check_cuda(r, k, v, w_log, u, chunk)
    y = torch.empty((B, T, nh, hd), dtype=torch.float32, device=r.device)
    s = (torch.empty((B, nh, hd, hd), dtype=torch.float32, device=r.device)
         if return_state else None)
    lib = _lib()
    err = lib.wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        u.data_ptr(), y.data_ptr(), None if s is None else s.data_ptr(),
        B, T, nh, hd, chunk, _DTYPE_CODE[r.dtype], _DTYPE_CODE[w_log.dtype],
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, "wkv launch")
    wkv_kernel.launches += 1
    return (y, s) if return_state else y


wkv_kernel.launches = 0


@functools.lru_cache(maxsize=None)
def _step_lib() -> ctypes.CDLL:
    lib = build.load("wkv_step")
    lib.wkv_step_launch.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.wkv_step_launch.restype = ctypes.c_int
    return lib


def wkv_step(r, k, v, e, u, s0, *, out=None):
    """One decode step of the WKV recurrence: r, k, v and the decay ``e =
    exp(w_log)`` (B, nh, 64), u (nh, 64), the state s0 (B, nh, 64, 64).
    Returns (y (B, nh, 64) f32, s' (B, nh, 64, 64) f32); s' is written into
    ``out`` where one is given, which may be s0 itself (the step in
    place).  A CPU tensor takes the plain version (``ref.wkv_step_plain``);
    a CUDA tensor launches W1 on the current stream (every input and
    ``out`` f32 and contiguous, or it raises), whose sums run in one order
    a row (``ref.wkv_step_ordered``).  No host sync, so the step can be
    captured in a CUDA graph.  Launches are counted in
    ``wkv_step.launches``."""
    B, nh, hd = r.shape
    if any(tuple(x.shape) != (B, nh, hd) for x in (k, v, e)) \
            or tuple(u.shape) != (nh, hd) \
            or tuple(s0.shape) != (B, nh, hd, hd):
        raise ValueError(f"wkv_step: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, e "
                         f"{tuple(e.shape)}, u {tuple(u.shape)}, s0 "
                         f"{tuple(s0.shape)}")
    if out is not None and tuple(out.shape) != tuple(s0.shape):
        raise ValueError(f"wkv_step: out {tuple(out.shape)} for the state "
                         f"{tuple(s0.shape)}")
    if r.device.type == "cpu":
        y, s = wkv_step_plain(r, k, v, e, u, s0)
        return y, s if out is None else out.copy_(s)
    s = torch.empty_like(s0) if out is None else out
    xs = (r, k, v, e, u, s0, s)
    if any(x.device != r.device for x in xs):
        raise ValueError("wkv_step: inputs on different devices")
    if any(x.dtype != torch.float32 for x in xs):
        raise TypeError("wkv_step: every input must be float32, got "
                        + ", ".join(str(x.dtype) for x in xs))
    if hd != HEAD_DIM:
        raise ValueError(f"wkv_step: head dim {hd}; the kernel takes "
                         f"{HEAD_DIM}")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError("wkv_step: inputs must be contiguous")
    y = torch.empty_like(r)
    lib = _step_lib()
    err = lib.wkv_step_launch(
        *(x.data_ptr() for x in (*xs[:6], y, s)), B, nh, hd,
        torch.cuda.current_stream(r.device).cuda_stream)
    build.check(lib, err, "wkv_step launch")
    wkv_step.launches += 1
    return y, s


wkv_step.launches = 0
