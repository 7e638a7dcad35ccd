"""Public WKV API (``repro/kernels/wkv/ops.py``): padding and dispatch to
K7.

``wkv`` is the reference's entry: the chunk defaults to the ``wkv`` row of
``kernels.tuning`` and, on the CPU, is clamped to the sequence; T is
zero-padded to a whole number of chunks, and y comes back f32.  On the card
the chunk is the kernel's one (``tuning.WKV_CHUNK``) and only padded to.  ``wkv_state`` is the entry
of the model's prefill (the reference's ``models/rwkv6.py``
``wkv_chunked``): the caller's chunk as it is, no clamp, and the final state
beside y.  Zero padding changes neither: a padded position has r = k = v = 0
and no decay.  A CPU tensor runs the plain version, a CUDA tensor K7.

``wkv_step`` is the entry of the model's decode step: one token against
the carried state, through W1 on the card (``kernel.wkv_step``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import as_tensor
from repro_torch.kernels import tuning
from repro_torch.kernels.wkv import kernel as _kernel
from repro_torch.kernels.wkv.kernel import wkv_kernel


def _run(r, k, v, w_log, u, chunk: int, state: bool):
    T = r.shape[1]
    pad = (-T) % chunk
    if pad:
        r, k, v, w_log = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (r, k, v, w_log))
    out = wkv_kernel(*(x.contiguous() for x in (r, k, v, w_log, u)),
                     chunk=chunk, return_state=state)
    if state:
        return out[0][:, :T], out[1]
    return out[:, :T]


def wkv(r, k, v, w_log, u, *, chunk: Optional[int] = None,
        device=None) -> torch.Tensor:
    """y (B, T, nh, hd) f32 of the WKV recurrence.  r, k, v, w_log:
    (B, T, nh, hd); u: (nh, hd).  Tensors run where they lie; numpy arrays
    go to ``device`` (default ``"cuda"``).  ``chunk=None`` takes the tuning
    row; on the CPU any chunk is clamped as the reference clamps it
    (``tuning.clamp_wkv_chunk``), on the card it must be the kernel's."""
    r, k, v, w_log, u = (as_tensor(x, device) for x in (r, k, v, w_log, u))
    T = r.shape[1]
    if chunk is None:
        chunk = tuning.wkv_chunk(T, r.dtype, r.device)
    chunk = tuning.clamp_wkv_chunk(chunk, T, r.device)
    return _run(r, k, v, w_log, u, chunk, state=False)


def wkv_state(r, k, v, w_log, u, *, chunk: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, T, nh, hd) f32, final state (B, nh, hd, hd) f32) with T padded
    to a multiple of ``chunk``, unclamped (the model's prefill)."""
    return _run(r, k, v, w_log, u, int(chunk), state=True)


def wkv_step(r, k, v, e, u, s0, *, out=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, nh, hd) f32, s' (B, nh, hd, hd) f32) of one decode step: r,
    k, v, the decay ``e = exp(w_log)`` (B, nh, hd), u (nh, hd), the state
    s0 (B, nh, hd, hd); each made f32 and contiguous first.  s' goes into
    ``out`` where one is given (an f32 contiguous state, s0's own storage
    included: the model's cache leaf)."""
    return _kernel.wkv_step(*(x.float().contiguous()
                              for x in (r, k, v, e, u, s0)), out=out)


def flops(B, T, nh, hd, chunk=128) -> int:
    """Dots only: intra-chunk (2 x Q^2 x hd x 2) + inter-chunk (2 x Q x hd^2)
    + state update (2 x Q x hd^2), per (b, h, c)."""
    nc = -(-T // chunk)
    per = 4 * chunk * chunk * hd + 4 * chunk * hd * hd
    return B * nh * nc * per
