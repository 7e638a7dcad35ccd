"""Wrapper of M1 (``csrc/ssd_step.cu``), the one-token Mamba-2 SSD step,
which has no Pallas counterpart: the reference computes it as array code
(``src/repro/models/mamba2.py:144-147``).

A CPU tensor takes the plain version (``ref.ssd_step_plain``); a CUDA
tensor launches M1 on the current stream or raises: every input and
``out`` f32 and contiguous, the state on 16 bytes, (hd, ns) one of
:data:`INSTANCES`.  Launches are counted in ``ssd_step.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import ssd_step_plain

# (head dim, state) instances compiled into the source: zamba2-1.2b's
# CONFIG and SMOKE
INSTANCES = ((64, 64), (16, 16))
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_step")
    lib.ssd_step_launch.argtypes = [_P] * 7 + [_I] * 4 + [_P]
    lib.ssd_step_launch.restype = ctypes.c_int
    return lib


def ssd_step(x, e, b, c, h0, *, out=None):
    """One decode step of the SSD recurrence: x (B, nh, hd), the decay e
    (B, nh), b and c (B, ns), the state h0 (B, nh, hd, ns).  Returns (y (B,
    nh, hd) f32, h' (B, nh, hd, ns) f32); h' is written into ``out`` where
    one is given, which may be h0 itself (the step in place).  On the card
    y sums in one order a row (``ref.ssd_step_ordered``) and h' is bit for
    bit the plain step's.  No host sync, so the step can be captured in a
    CUDA graph."""
    B, nh, hd = x.shape
    ns = b.shape[-1]
    if tuple(e.shape) != (B, nh) or tuple(b.shape) != (B, ns) \
            or tuple(c.shape) != (B, ns) \
            or tuple(h0.shape) != (B, nh, hd, ns):
        raise ValueError(f"ssd_step: shapes x {tuple(x.shape)}, e "
                         f"{tuple(e.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, h0 {tuple(h0.shape)}")
    if out is not None and tuple(out.shape) != tuple(h0.shape):
        raise ValueError(f"ssd_step: out {tuple(out.shape)} for the state "
                         f"{tuple(h0.shape)}")
    if x.device.type == "cpu":
        y, h = ssd_step_plain(x, e, b, c, h0)
        return y, h if out is None else out.copy_(h)
    h = torch.empty_like(h0) if out is None else out
    xs = (x, e, b, c, h0, h)
    if any(t.device != x.device for t in xs):
        raise ValueError("ssd_step: inputs on different devices")
    if any(t.dtype != torch.float32 for t in xs):
        raise TypeError("ssd_step: every input must be float32, got "
                        + ", ".join(str(t.dtype) for t in xs))
    if (hd, ns) not in INSTANCES:
        raise ValueError(f"ssd_step: (head dim, state) ({hd}, {ns}); the "
                         f"kernel takes {INSTANCES}")
    if not all(t.is_contiguous() for t in xs):
        raise ValueError("ssd_step: inputs must be contiguous")
    if h0.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("ssd_step: the states must start on 16 bytes (rows "
                         "move as 16-byte pieces)")
    y = torch.empty_like(x)
    lib = _lib()
    err = lib.ssd_step_launch(
        *(t.data_ptr() for t in (x, e, b, c, h0, y, h)), B, nh, hd, ns,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "ssd_step launch")
    ssd_step.launches += 1
    return y, h


ssd_step.launches = 0
