"""Plain PyTorch versions of the WKV recurrence (K7).

``wkv_chunked_plain`` is the chunked form of the reference's
``models/rwkv6.py`` ``wkv_chunked`` (zero padding to whole chunks, the
mid-chunk exponent rescale, the chunk-to-chunk state scan), with every input
widened to f32 first, as the Pallas kernel ``wkv_pallas`` does.  It returns
the final state beside ``y``; the CUDA kernel computes the same and is held
against it on the card.  ``wkv_scan`` is the sequential oracle
(``rwkv_scan_ref``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _f32(*xs):
    return tuple(x.float() for x in xs)


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
