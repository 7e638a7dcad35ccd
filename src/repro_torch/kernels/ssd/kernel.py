"""Wrapper of M1 (``csrc/ssd_step.cu``), a Mamba-2 layer's whole decode
step from the causal conv's output to the gated norm's input, which has no
Pallas counterpart: the reference computes it as array code
(``src/repro/models/mamba2.py:132-151``).

A CPU tensor takes the plain version (``ref.mamba_step_plain``); a CUDA
tensor launches M1 on the current stream or raises: ``xs``, ``b``, ``c``,
``z`` and ``dt`` in one dtype of :data:`DTYPES`, each a batch of rows whose
elements are contiguous (views of the conv's output and of the projection,
as they lie: no copy); ``a_log``, ``dt_bias``, ``d_skip`` and the states
f32 and contiguous, the states on 16 bytes; (hd, ns) one of
:data:`INSTANCES`.  Launches are counted in ``ssd_step.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd.ref import mamba_step_plain

# (head dim, state) instances compiled into the source: zamba2-1.2b's
# CONFIG and SMOKE
INSTANCES = ((64, 64), (16, 16))
# the compute dtypes compiled into the source, by the launcher's code
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_step")
    lib.ssd_step_launch.argtypes = \
        [_P] * 11 + [_I] * 4 + [_L] * 5 + [_I] + [_P]
    lib.ssd_step_launch.restype = ctypes.c_int
    return lib


def ssd_step(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0, *, out=None):
    """One Mamba-2 decode step (``ref.mamba_step_plain``'s arguments):
    ``xs`` and ``z`` (B, d_in), ``b`` and ``c`` (B, ns), ``dt`` (B, nh) in
    the compute dtype; ``a_log``, ``dt_bias``, ``d_skip`` (nh) and h0 (B,
    nh, hd, ns) f32.  Returns (the gated output (B, d_in) in the compute
    dtype, h' (B, nh, hd, ns) f32); h' is written into ``out`` where one is
    given, which may be h0 itself (the step in place).  On the card the
    output is ``ref.mamba_step_ordered``'s bits and h' the plain step's.  No
    host sync, so the step can be captured in a CUDA graph."""
    B, d_in = xs.shape
    nh = dt.shape[-1]
    ns = b.shape[-1]
    hd = d_in // nh
    if tuple(h0.shape) != (B, nh, hd, ns) or nh * hd != d_in \
            or any(tuple(t.shape) != (B, ns) for t in (b, c)) \
            or tuple(z.shape) != (B, d_in) or tuple(dt.shape) != (B, nh) \
            or any(tuple(w.shape) != (nh,) for w in (a_log, dt_bias,
                                                      d_skip)):
        raise ValueError(
            f"ssd_step: shapes xs {tuple(xs.shape)}, b {tuple(b.shape)}, c "
            f"{tuple(c.shape)}, z {tuple(z.shape)}, dt {tuple(dt.shape)}, "
            f"a_log / dt_bias / d_skip {tuple(a_log.shape)} / "
            f"{tuple(dt_bias.shape)} / {tuple(d_skip.shape)}, h0 "
            f"{tuple(h0.shape)}")
    if out is not None and tuple(out.shape) != tuple(h0.shape):
        raise ValueError(f"ssd_step: out {tuple(out.shape)} for the state "
                         f"{tuple(h0.shape)}")
    if xs.device.type == "cpu":
        y, h = mamba_step_plain(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0)
        return y, h if out is None else out.copy_(h)
    h = torch.empty_like(h0) if out is None else out
    rows, layer = (xs, b, c, z, dt), (a_log, dt_bias, d_skip, h0, h)
    if any(t.device != xs.device for t in rows + layer):
        raise ValueError("ssd_step: inputs on different devices")
    if xs.dtype not in DTYPES or any(t.dtype != xs.dtype for t in rows) \
            or any(t.dtype != torch.float32 for t in layer):
        raise TypeError(
            "ssd_step: xs, b, c, z, dt in one of float32 / bfloat16 and the "
            "rest float32, got " + ", ".join(str(t.dtype)
                                             for t in rows + layer))
    if (hd, ns) not in INSTANCES:
        raise ValueError(f"ssd_step: (head dim, state) ({hd}, {ns}); the "
                         f"kernel takes {INSTANCES}")
    if any(t.stride(-1) != 1 for t in rows) \
            or not all(t.is_contiguous() for t in layer):
        raise ValueError("ssd_step: each row of xs, b, c, z, dt must be "
                         "contiguous, and a_log, dt_bias, d_skip and the "
                         "states contiguous")
    if h0.data_ptr() % 16 or h.data_ptr() % 16:
        raise ValueError("ssd_step: the states must start on 16 bytes (the "
                         "state moves as 16-byte pieces)")
    y = torch.empty((B, d_in), dtype=xs.dtype, device=xs.device)
    lib = _lib()
    err = lib.ssd_step_launch(
        *(t.data_ptr() for t in rows + layer[:4]), y.data_ptr(),
        h.data_ptr(), B, nh, hd, ns, *(t.stride(0) for t in rows),
        DTYPES[xs.dtype], torch.cuda.current_stream(xs.device).cuda_stream)
    build.check(lib, err, "ssd_step launch")
    ssd_step.launches += 1
    return y, h


ssd_step.launches = 0
