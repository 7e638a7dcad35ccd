"""Attention ops of the port.  Only ``decode_attention`` is ported so far:
plain PyTorch, as in the reference, where it is array code and no Pallas
kernel (the flash kernels serve ``impl="kernel"`` and masked prefill, which
are not ported yet)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len: Optional[int] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode: q1 (B, Hq, 1, D) against a (B, Hkv, S, D) cache.

    Arithmetic is prefix-aligned with ``layers.chunked_attention`` (the
    prefill path): operands stream in the cache dtype with f32 products and
    sums, and the narrow cast applies to the UNNORMALIZED ``exp(s - m)``;
    the f32 PV product is divided by the f32 row sum afterwards.  Casting
    after normalizing would quantize another quantity than prefill does and
    can flip near-tie MoE router argmaxes between decode and prefill.
    ``kv_len`` masks the cache tail beyond the current length."""
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    g = Hq // Hkv
    scale = D ** -0.5
    qg = (q1 * scale).to(k_cache.dtype).reshape(B, Hkv, g, 1, D)
    s = torch.matmul(qg.float(), k_cache.float()[:, :, None].transpose(-1, -2))
    pos = torch.arange(S, device=q1.device)
    if kv_len is not None:
        keep = pos < kv_len
        if window is not None:
            keep &= pos >= kv_len - window
        s = s.masked_fill(~keep, NEG_INF)
    elif window is not None:
        s = s.masked_fill(pos < S - window, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)                      # unnormalized, like prefill
    l = p.sum(dim=-1, keepdim=True)           # f32 row sum
    out = torch.matmul(p.to(v_cache.dtype).float(), v_cache.float()[:, :, None])
    out = out / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, 1, D).to(q1.dtype)
