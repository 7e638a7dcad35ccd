"""Plain PyTorch versions of the one-token SSD step (M1, ``csrc/ssd_step.cu``).

The reference computes a Mamba-2 decode step as array code
(``src/repro/models/mamba2.py:144-147``): per (batch, head), with the
dt-scaled input ``x`` (hd), the decay ``e = exp(a * dt)``, the token's B and
C (ns each) and the (hd, ns) f32 state h0,

    h'[d, s] = h0[d, s] e + x[d] B[s]
    y[d]     = sum_s C[s] h'[d, s]

:func:`ssd_step_plain` is that step as the reference writes it (its
einsums), the CPU path of ``kernel.ssd_step``; :func:`ssd_step_ordered` is
M1's summation order in elementwise PyTorch, which the kernel gives bit for
bit on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_step_plain(x, e, b, c, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step as the reference writes it: x (B, nh, hd), e (B,
    nh), b and c (B, ns), h0 (B, nh, hd, ns), all f32.  Returns (y (B, nh,
    hd), h' (B, nh, hd, ns))."""
    h = h0 * e[:, :, None, None] + torch.einsum("bhd,bs->bhds", x, b)
    return torch.einsum("bs,bhds->bhd", c, h), h


def ssd_step_ordered(x, e, b, c, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """M1's order in PyTorch: h' as :func:`ssd_step_plain` (``h0 e``, then
    ``x B``, then their sum, each rounded to f32), and ``y[d] = sum_s C[s]
    h'[d, s]`` over s = 0, 1, ... in that order from +0, every product
    and sum rounded to f32.  Elementwise ops only, so a row's bits do not
    depend on the other rows."""
    h = h0 * e[:, :, None, None] + x[..., :, None] * b[:, None, None, :]
    y = torch.zeros_like(x)
    for s in range(h.shape[-1]):
        y = y + c[:, None, None, s] * h[..., s]
    return y, h
