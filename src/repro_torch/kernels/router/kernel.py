"""Wrapper of the router kernel R1 (``csrc/router.cu``): the MoE router's
f32 logits ``logits[t, e] = sum_d f32(x[t, d]) f32(W[d, e])`` in one
summation order per (token, expert), whatever the number of tokens, so a
token routes with the same bits in a prefill, a decode step, a batch
bucket or alone.  The reference computes the product as array code
(repro/models/moe.py:232); there is no Pallas kernel to port.

A CPU tensor takes the plain version (``ref.router_logits_ref``); a CUDA
tensor launches the kernel on the current stream or raises.  On the card x
and W are f32 or bf16, each in its own dtype (x is read as it is, no f32
copy).  The tile comes from ``tuning.router_tiles`` (T, E and the card's SM
count); no tile changes a bit.  Launches are counted in
``router_logits.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.router.ref import router_logits_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("router")
    return bind(lib)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``router.cu``'s launcher."""
    lib.router_launch.argtypes = [_P] * 3 + [_I] * 8 + [_P]
    lib.router_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch(lib: ctypes.CDLL, xt: torch.Tensor, wc: torch.Tensor,
           tiles: tuning.RouterTiles) -> torch.Tensor:
    """R1 of ``lib`` on contiguous x (T, d) and W (d, E) at ``tiles``:
    the (T, E) f32 logits.  Counts no launch."""
    T, d = xt.shape
    E = wc.shape[1]
    out = torch.empty((T, E), dtype=torch.float32, device=xt.device)
    err = lib.router_launch(
        xt.data_ptr(), wc.data_ptr(), out.data_ptr(), T, d, E,
        _DTYPE_CODE[xt.dtype], _DTYPE_CODE[wc.dtype], *tiles,
        torch.cuda.current_stream(xt.device).cuda_stream)
    if err:
        build.check(lib, err, f"router launch at {tuple(tiles)}")
    return out


def router_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d) f32 or bf16; w: (d, E) f32 or bf16.  Returns (..., E)
    f32."""
    if x.device.type == "cpu":
        return router_logits_ref(x, w)
    d = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != d or w.device != x.device:
        raise ValueError(f"router_logits: x {tuple(x.shape)} on {x.device} "
                         f"vs W {tuple(w.shape)} on {w.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"router_logits: x and W must be float32 or "
                        f"bfloat16, got {x.dtype} / {w.dtype}")
    E = w.shape[1]
    xt = x.reshape(-1, d).contiguous()
    wc = w.contiguous()
    T = xt.shape[0]
    if not T:
        return torch.empty((*x.shape[:-1], E), dtype=torch.float32,
                           device=x.device)
    lib = _lib()
    out = launch(lib, xt, wc,
                 tuning.router_tiles(T, E, _sms(x.device.index)))
    router_logits.launches += 1
    return out.reshape(*x.shape[:-1], E)


router_logits.launches = 0
