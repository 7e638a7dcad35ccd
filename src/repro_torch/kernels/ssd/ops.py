"""Public entry of a Mamba-2 layer's decode step from the causal conv's
output to the gated norm's input (``models.mamba2.apply_mamba``), through
M1 on the card (``kernel.ssd_step``)."""
from __future__ import annotations

from repro_torch.kernels.ssd.kernel import ssd_step  # noqa: F401


def state_bytes(B: int, nh: int, hd: int, ns: int, itemsize: int) -> int:
    """The bytes one step must move: the f32 state read and written; xs,
    z, B, C and dt read and the output written, ``itemsize`` bytes each;
    a_log, dt_bias and d_skip (f32) read."""
    d_in = nh * hd
    return (4 * (2 * B * nh * hd * ns + 3 * nh)
            + itemsize * B * (3 * d_in + 2 * ns + nh))
