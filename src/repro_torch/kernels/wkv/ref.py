"""Plain PyTorch versions of the WKV recurrence (K7).

``wkv_chunked_plain`` is the chunked form of the reference's
``models/rwkv6.py`` ``wkv_chunked`` (zero padding to whole chunks, the
mid-chunk exponent rescale, the chunk-to-chunk state scan), with every input
widened to f32 first, as the Pallas kernel ``wkv_pallas`` does.  It returns
the final state beside ``y``; the CUDA kernel computes the same and is held
against it on the card.  ``wkv_scan`` is the sequential oracle
(``rwkv_scan_ref``).

The one-token decode step (W1, ``csrc/wkv_step.cu``): ``wkv_step_plain``
is the reference's step (``models/rwkv6.py`` decode branch), the CPU path
of ``kernel.wkv_step``; ``wkv_step_ordered`` is W1's summation order in
elementwise PyTorch, which the kernel gives bit for bit on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _f32(*xs):
    """Each input widened to f32 (an f64 input kept, for gradient checks
    in f64)."""
    return tuple(x if x.dtype == torch.float64 else x.float() for x in xs)


def wkv_chunked_plain(r, k, v, w_log, u, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w_log: (B, T, nh, hd) (w_log < 0); u: (nh, hd).  Returns
    (y (B, T, nh, hd) f32, final state (B, nh, hd, hd) f32)."""
    r, k, v, w_log, u = _f32(r, k, v, w_log, u)
    B, T, nh, hd = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, w_log = (F.pad(x, (0, 0, 0, 0, 0, pad))
                          for x in (r, k, v, w_log))
    nc = (T + pad) // chunk
    rc, kc, vc, wc = (x.reshape(B, nc, chunk, nh, hd)
                      for x in (r, k, v, w_log))
    cum = torch.cumsum(wc, dim=2)                    # inclusive
    # intra-chunk, both exponents referred to the mid-chunk cumsum so that
    # each spans at most half a chunk of decay (f32 range at the clamp)
    ri = rc * torch.exp(cum - wc)
    mid = cum[:, :, chunk // 2: chunk // 2 + 1]
    ri_s = rc * torch.exp(cum - wc - mid)
    kj_s = kc * torch.exp(mid - cum)
    att = torch.einsum("bciht,bcjht->bchij", ri_s, kj_s)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=r.device).tril(-1)
    att = torch.where(mask, att, torch.zeros((), device=r.device))
    y = torch.einsum("bchij,bcjhd->bcihd", att, vc)
    diag = (rc * u * kc).sum(-1)                     # the u bonus
    y = y + diag[..., None] * vc
    # chunk-final states, then the scan over chunks
    decay_out = torch.exp(cum[:, :, -1:] - cum)
    S = torch.einsum("bcjht,bcjhd->bchtd", kc * decay_out, vc)
    w_tot = torch.exp(cum[:, :, -1])                 # (B, nc, nh, hd)
    s = torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=r.device)
    s_prev = []
    for c in range(nc):
        s_prev.append(s)
        s = s * w_tot[:, c, :, :, None] + S[:, c]
    s_prev = torch.stack(s_prev, dim=1)              # (B, nc, nh, hd, hd)
    y = y + torch.einsum("bciht,bchtd->bcihd", ri, s_prev)
    return y.reshape(B, nc * chunk, nh, hd)[:, :T], s


def wkv_scan(r, k, v, w_log, u, s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence, one step per position (the oracle):
    y_t = r_t S + (r_t . (u * k_t)) v_t, S = diag(exp(w_t)) S + k_t v_t^T.
    Computes in the inputs' dtype (pass f64 for a reference).  Returns
    (y (B, T, nh, hd), final state (B, nh, hd, hd))."""
    B, T, nh, hd = r.shape
    s = (s0 if s0 is not None else
         torch.zeros((B, nh, hd, hd), dtype=r.dtype, device=r.device))
    ys = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w_log[:, t]
        ys.append(torch.einsum("bht,bhtd->bhd", rt, s)
                  + (rt * u * kt).sum(-1)[..., None] * vt)
        s = s * torch.exp(wt)[..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(ys, dim=1), s


def wkv_step_plain(r, k, v, e, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step of the recurrence as the reference writes it: r, k,
    v and the decay ``e = exp(w_log)`` (B, nh, hd) f32, u (nh, hd), s0 (B,
    nh, hd, hd) f32.  Returns (y (B, nh, hd), s' (B, nh, hd, hd))."""
    y1 = torch.einsum("bht,bhtd->bhd", r, s0)
    bonus = (r * u * k).sum(-1)
    y = y1 + bonus[..., None] * v
    s = s0 * e[..., None] + k[..., :, None] * v[..., None, :]
    return y, s


def wkv_step_ordered(r, k, v, e, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """W1's order in PyTorch: ``y[d] = sum_t r[t] s0[t, d]`` and the bonus
    ``sum_t (r[t] u[t]) k[t]`` each summed over t = 0, 1, ... in that
    order from +0, every product and sum rounded to f32, then ``y +
    bonus v``; s' as :func:`wkv_step_plain`.  Elementwise ops only, so a
    row's bits do not depend on the other rows."""
    ru = r * u
    y = torch.zeros_like(r)
    bonus = torch.zeros_like(r[..., 0])
    for t in range(r.shape[-1]):
        y = y + r[..., t, None] * s0[..., t, :]
        bonus = bonus + ru[..., t] * k[..., t]
    y = y + bonus[..., None] * v
    s = s0 * e[..., None] + k[..., :, None] * v[..., None, :]
    return y, s
