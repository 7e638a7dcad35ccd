"""Mamba-2 mixer (SSD, chunked) -- Zamba-2's backbone layer.

The port of ``repro/models/mamba2.py``.  The SSD recurrence
``h_t = a_t * h_{t-1} + dt_t * x_t B_t^T`` runs chunked in prefill
(:func:`ssd_chunked`: an intra-chunk quadratic part and an inter-chunk
state scan, plain PyTorch, as the reference's is array code) and one token
at a time in decode, where ``kernels.ssd.ops.ssd_step`` takes the whole
step from the conv's output to the gated norm's input (M1 on the card:
softplus and the decay, the state update, y summed over the state in one
order a row, the skip and the gate in one kernel, so a request decodes the
same bits in any batch; the plain step on the CPU).

Shapes: x (B, T, d); d_in = expand * d; nh = d_in / ssm_head_dim heads;
state ns.  Params are stacked on a leading layer dim like every slot param
of ``models.model``: the fused projection ``w_in`` (d, 2 d_in + 2 ns + nh),
``w_out`` and the depthwise conv's ``conv_w`` / ``conv_b`` in the policy's
compute dtype (the reference casts them at every use); ``a_log``,
``d_skip`` and ``dt_bias`` f32, as the reference uses them.
:func:`mamba_scan_ref` is the sequential oracle of the tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

# the chunk of the model's prefill (the reference's ``apply_mamba``)
CHUNK = 256


def init_mamba(g: torch.Generator, cfg: ArchConfig, *, n: int, dtype,
               device):
    """Random mixer params with the reference's scales, ``n`` layers
    stacked."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = d_in // hd
    conv_ch = d_in + 2 * ns
    kw = dict(n=n, dtype=dtype, device=device)
    a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    return {
        # fused input projection: [x(d_in), B(ns), C(ns), z(d_in), dt(nh)]
        "w_in": L.normal(g, (d, 2 * d_in + 2 * ns + nh), d ** -0.5, **kw),
        "conv_w": L.normal(g, (cfg.ssm_conv, conv_ch), 0.1, **kw),
        "conv_b": torch.zeros((n, conv_ch), dtype=dtype, device=device),
        "a_log": a_log.expand(n, nh).clone(),
        "d_skip": torch.ones((n, nh), device=device),
        "dt_bias": torch.zeros((n, nh), device=device),
        "norm": L.init_rmsnorm(d_in, n=n, device=device),
        "w_out": L.normal(g, (d_in, d), d_in ** -0.5, **kw),
    }


def _split_proj(p, x: torch.Tensor, cfg: ArchConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    ns = cfg.ssm_state
    nh = d_in // cfg.ssm_head_dim
    proj = x @ p["w_in"].to(x.dtype)
    xs, Bv, Cv, z, dt = torch.split(proj, [d_in, ns, ns, d_in, nh], dim=-1)
    return xs, Bv, Cv, z, dt, d_in, ns, nh


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev=None):
    """Depthwise causal conv over time. xBC: (B, T, C); w: (K, C).  The K
    taps summed in tap order, then the bias, then SiLU.  ``prev``: (B,
    K-1, C) carry-in for decode; returns (out, the last K-1 inputs: the
    new carry)."""
    K = w.shape[0]
    T = xBC.shape[1]
    if prev is None:
        prev = xBC.new_zeros((xBC.shape[0], K - 1, xBC.shape[2]))
    full = torch.cat([prev, xBC], dim=1)
    out = sum(full[:, i:i + T] * w[i] for i in range(K)) + b
    return F.silu(out), full[:, -(K - 1):]


def ssd_chunked(xh, a_log, Bv, Cv, *, chunk: int = 64, h0=None):
    """Chunked SSD. xh: (B, T, nh, hd) (already dt-scaled); a_log: (B, T,
    nh) (<= 0); Bv / Cv: (B, T, ns); all f32.  Returns (y (B, T, nh, hd),
    h_final (B, nh, hd, ns)).

    The reference's intra-chunk three-operand einsum becomes the decay
    matrix masked before ``exp`` (the i < j region has positive exponents
    that overflow), then scaled by the scores, in (B, nc, nh, Q, Q) (537 MB
    f32 at 4 x 2048, Q 256), then one batched product over (b, c, h)
    against x: never a (B, nc, Q, Q, nh, hd) intermediate.  The scaling is
    out of place, so the backward of the in-place ``exp_`` reads the decay
    matrix as it left it."""
    B, T, nh, hd = xh.shape
    ns = Bv.shape[-1]
    pad = (-T) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a_log, Bv, Cv = (F.pad(t, (0, 0, 0, pad)) for t in (a_log, Bv, Cv))
    nc = (T + pad) // chunk
    xc = xh.reshape(B, nc, chunk, nh, hd)
    Bc = Bv.reshape(B, nc, chunk, ns)
    Cc = Cv.reshape(B, nc, chunk, ns)
    cum = torch.cumsum(a_log.reshape(B, nc, chunk, nh), dim=2)
    cum_h = cum.transpose(2, 3)                          # (B, nc, nh, Q)

    # intra-chunk: W[i, j] = (C_i . B_j) exp(cum_i - cum_j) for i >= j
    W = cum_h[..., :, None] - cum_h[..., None, :]        # (B, nc, nh, Q, Q)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()
    W.masked_fill_(~causal, float("-inf"))
    W.exp_()
    # out of place: the backward of exp_ reads W as exp_ left it
    W = W * torch.einsum("bcis,bcjs->bcij", Cc, Bc)[:, :, None]
    y_intra = torch.matmul(W, xc.transpose(2, 3))        # (B, nc, nh, Q, hd)
    del W

    # chunk-final states: S_c = sum_j exp(cum_Q - cum_j) B_j (x) xh_j
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)       # (B, nc, Q, nh)
    S = torch.einsum("bcjhd,bcjs->bchds", xc * decay_out[..., None], Bc)

    # inter-chunk recurrence over c
    a_tot = torch.exp(cum[:, :, -1, :])                  # (B, nc, nh)
    h = (torch.zeros((B, nh, hd, ns), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * a_tot[:, c, :, None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # (B, nc, nh, hd, ns)

    # y_inter_i = exp(cum_i) * C_i . h_prev
    y_inter = (torch.einsum("bcis,bchds->bcihd", Cc, h_prev)
               * torch.exp(cum)[..., None])
    y = y_intra.transpose(2, 3) + y_inter
    return y.reshape(B, nc * chunk, nh, hd)[:, :T], h


def apply_mamba(p, x: torch.Tensor, cfg: ArchConfig, *, cache=None,
                collect: bool = False):
    """Mamba-2 block.  ``cache`` = dict(conv (B, K-1, C), ssm (B, nh, hd,
    ns) f32) for decode (T == 1): the step writes the new conv carry and
    state into those leaves **in place** (M1 steps the state in place on
    the card) and returns the same dict; ``collect`` returns the
    prefill-final cache.  Returns (out, new_cache)."""
    B, T, _ = x.shape
    xs, Bv, Cv, z, dt, d_in, ns, nh = _split_proj(p, x, cfg)
    hd = cfg.ssm_head_dim
    cd = x.dtype
    xBC = torch.cat([xs, Bv, Cv], dim=-1)
    prev = None if cache is None else cache["conv"]
    xBC, conv_new = _causal_conv(xBC, p["conv_w"].to(cd), p["conv_b"].to(cd),
                                 prev)
    xs, Bv, Cv = torch.split(xBC, [d_in, ns, ns], dim=-1)

    if cache is None:
        dt = F.softplus(dt.float() + p["dt_bias"])               # (B, T, nh)
        a_log = -torch.exp(p["a_log"]) * dt
        xh = xs.float().reshape(B, T, nh, hd) * dt[..., None]
        y, h_last = ssd_chunked(xh, a_log, Bv.float(), Cv.float(),
                                chunk=CHUNK)
        new_cache = {"conv": conv_new, "ssm": h_last} if collect else None
        y = y + p["d_skip"][:, None] * xs.float().reshape(B, T, nh, hd)
        y = y.reshape(B, T, d_in).to(cd) * F.silu(z)
    else:
        y, _ = ssd_ops.ssd_step(xs[:, 0], Bv[:, 0], Cv[:, 0], z[:, 0],
                                dt[:, 0], p["a_log"], p["dt_bias"],
                                p["d_skip"], cache["ssm"], out=cache["ssm"])
        y = y[:, None]
        cache["conv"].copy_(conv_new)
        new_cache = cache
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps, row_order=cache is not None)
    return y @ p["w_out"].to(cd), new_cache


def mamba_scan_ref(xh, a_log, Bv, Cv, h0=None):
    """Naive sequential oracle for :func:`ssd_chunked` (tests only)."""
    B, T, nh, hd = xh.shape
    ns = Bv.shape[-1]
    h = (h0 if h0 is not None else
         torch.zeros((B, nh, hd, ns), dtype=torch.float32, device=xh.device))
    ys = []
    for t in range(T):
        h = (h * torch.exp(a_log[:, t])[:, :, None, None]
             + torch.einsum("bhd,bs->bhds", xh[:, t], Bv[:, t]))
        ys.append(torch.einsum("bs,bhds->bhd", Cv[:, t], h))
    return torch.stack(ys, dim=1), h
