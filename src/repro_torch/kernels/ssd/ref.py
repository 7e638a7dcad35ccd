"""Plain PyTorch versions of the Mamba-2 decode step (M1, ``csrc/ssd_step.cu``).

The reference computes a Mamba-2 decode step as array code
(``src/repro/models/mamba2.py:132-135``, ``:141-147``, ``:149-151``): from
the causal conv's output ``xs`` (d_in), the token's B and C (ns each), the
projection's gate ``z`` (d_in) and raw ``dt`` (nh), and the layer's f32
``a_log``, ``dt_bias`` and ``d_skip`` (nh), per (batch, head)

    dt'      = softplus(dt + dt_bias)
    e        = exp(-exp(a_log) dt')
    x[d]     = xs[d] dt'
    h'[d, s] = h0[d, s] e + x[d] B[s]
    y[d]     = sum_s C[s] h'[d, s] + d_skip xs[d]
    out      = y (in the compute dtype) * silu(z)

:func:`mamba_step_plain` is that step, op for op as ``apply_mamba``'s
decode branch ran it before M1 took the whole step: the CPU path of
``kernel.ssd_step``.  :func:`mamba_step_ordered` is the same with y summed
in M1's order, which the kernel gives bit for bit on the card.  Both are
built on the SSD recurrence alone: :func:`ssd_step_plain` (the reference's
einsums) and :func:`ssd_step_ordered` (M1's order in elementwise PyTorch).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def ssd_step_plain(x, e, b, c, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the SSD recurrence as the reference writes it: the
    dt-scaled x (B, nh, hd), the decay e (B, nh), b and c (B, ns), h0 (B,
    nh, hd, ns), all f32.  Returns (y (B, nh, hd), h' (B, nh, hd, ns))."""
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


def _mamba_step(step, xs, b, c, z, dt, a_log, dt_bias, d_skip, h0):
    B, d_in = xs.shape
    nh = dt.shape[-1]
    hd = d_in // nh
    cd = xs.dtype
    dt = F.softplus(dt.float() + dt_bias)                       # (B, nh)
    a = -torch.exp(a_log) * dt
    xh = xs.float().reshape(B, nh, hd) * dt[..., None]
    y, h = step(xh, torch.exp(a), b.float(), c.float(), h0)
    y = y + d_skip[:, None] * xs.float().reshape(B, nh, hd)
    y = y.reshape(B, d_in).to(cd)
    return y * F.silu(z), h


def mamba_step_plain(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole decode step from the conv's output to the gated norm's
    input: ``xs`` (B, d_in), ``b`` and ``c`` (B, ns), ``z`` (B, d_in) and
    ``dt`` (B, nh) in the compute dtype; ``a_log``, ``dt_bias`` and
    ``d_skip`` (nh) and the state h0 (B, nh, hd, ns) f32.  Returns (the
    gated output (B, d_in) in the compute dtype, h' (B, nh, hd, ns) f32),
    through :func:`ssd_step_plain`."""
    return _mamba_step(ssd_step_plain, xs, b, c, z, dt, a_log, dt_bias,
                       d_skip, h0)


def mamba_step_ordered(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_step_plain` with :func:`ssd_step_ordered` in place of
    :func:`ssd_step_plain`: M1's order, which the kernel gives bit for bit
    on the card."""
    return _mamba_step(ssd_step_ordered, xs, b, c, z, dt, a_log, dt_bias,
                       d_skip, h0)
