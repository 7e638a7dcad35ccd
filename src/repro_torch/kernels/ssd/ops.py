"""Public entry of the one-token SSD step: the Mamba-2 decode step of
``models.mamba2.apply_mamba``, through M1 on the card
(``kernel.ssd_step``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd import kernel as _kernel


def ssd_step(x, e, b, c, h0, *, out=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, nh, hd) f32, h' (B, nh, hd, ns) f32) of one decode step: the
    dt-scaled input x (B, nh, hd), the decay ``e = exp(a dt)`` (B, nh), the
    token's B and C (B, ns), the state h0 (B, nh, hd, ns); each made f32 and
    contiguous first.  h' goes into ``out`` where one is given (an f32
    contiguous state, h0's own storage included: the model's cache
    leaf)."""
    return _kernel.ssd_step(*(t.float().contiguous()
                              for t in (x, e, b, c, h0)), out=out)


def state_bytes(B: int, nh: int, hd: int, ns: int) -> int:
    """The bytes one step must move: the state read and written, x and y,
    e, B and C, all f32."""
    return 4 * (2 * B * nh * hd * ns + 2 * B * nh * hd + B * nh + 2 * B * ns)
