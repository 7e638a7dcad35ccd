"""Neural-net layer primitives: norms, RoPE, GQA attention, MLPs.

Pure functions on tensors with parameter dicts, as in the reference.
Prefill attention is ``impl="chunked"`` (online softmax over KV chunks, the
default), ``"kernel"`` (the flash kernel K3) or ``"ref"`` (the materialized
oracle); an ``attn_mask`` (``AttnMaskSpec``) sends prefill through the masked
flash kernels (K4s / K4m).  Decode is ``decode_attention`` at a scalar
cache position or at per-row positions (continuous batching); a quantized
cache (``kv_quant``: narrow K/V with per-position f32 scales) is
dequantized whole before it.  A local layer's cache of exactly ``window``
slots is a ring buffer (position ``p`` at slot ``p % window``).  Not ported
yet: ``impl="kernel_sharded"``.

Matmuls take operands in the compute dtype: a bf16 x bf16 product gives a
bf16 result accumulated in f32 (reduced-precision reductions are off, see
``repro_torch.set_numerics``).  Where the reference asks for an f32 result
of narrow operands (``preferred_element_type``), the operands are widened to
f32 first: the products are exact and the sum is f32.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import precision
from repro_torch.core.masks import NEG_INF, AttnMaskSpec
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.router import ops as router_ops
from repro_torch.models.config import ArchConfig


# ------------------------------------------------------------------ init ----

# the largest f32 temporary of one draw of :func:`normal`: a repeat slice
# past it (llama4-maverick's 128 stacked experts, 21.5 GB in f32) is drawn
# in pieces along its first dim; every smaller slice is one draw
DRAW_BYTES = 6 * 2**30


def normal(g: torch.Generator, shape, scale: float, *, n: int, dtype,
           device) -> torch.Tensor:
    """(n,) + shape stacked N(0, 1) * scale weights, drawn per repeat slice
    in f32 then stored in ``dtype`` (no full-stack f32 temporary; a slice
    of more than :data:`DRAW_BYTES` in f32 drawn in pieces of at most
    that along its first dim)."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    row = 4 * math.prod(shape[1:])
    step = max(1, DRAW_BYTES // row)
    for i in range(n):
        for j in range(0, shape[0], step):
            piece = (min(step, shape[0] - j),) + tuple(shape[1:])
            out[i, j:j + step] = torch.randn(piece, generator=g,
                                             device=device) * scale
    return out


def init_rmsnorm(d: int, *, n: int, device):
    return {"scale": torch.ones((n, d), dtype=torch.float32, device=device)}


def init_attention(g, cfg: ArchConfig, *, n: int, dtype, device):
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    kw = dict(n=n, dtype=dtype, device=device)
    p = {"wq": normal(g, (d, Hq * hd), s, **kw),
         "wk": normal(g, (d, Hkv * hd), s, **kw),
         "wv": normal(g, (d, Hkv * hd), s, **kw),
         "wo": normal(g, (Hq * hd, d), s, **kw)}
    if cfg.qkv_bias:
        for name, width in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros((n, width * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, n=n, device=device)
        p["k_norm"] = init_rmsnorm(hd, n=n, device=device)
    return p


def init_mlp(g, cfg: ArchConfig, *, n: int, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(n=n, dtype=dtype, device=device)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": normal(g, (d, ff), d ** -0.5, **kw),
                "w_up": normal(g, (d, ff), d ** -0.5, **kw),
                "w_down": normal(g, (ff, d), ff ** -0.5, **kw)}
    return {"w_up": normal(g, (d, ff), d ** -0.5, **kw),
            "w_down": normal(g, (ff, d), ff ** -0.5, **kw)}


# ----------------------------------------------------------------- norms ----

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6, *,
            row_order: bool = False) -> torch.Tensor:
    """RMS norm over the last axis.  ``row_order`` (the decode step's
    norms): the sum of squares comes from ``router.ops.row_sum``, one
    summation order a row on the card (R1), so a row normalizes to the
    same bits in any batch; the library's mean lays its reduction's threads
    out by the number of rows, so its bits depend on the batch.  On the CPU
    the sum over d is the mean's own arithmetic, bit for bit."""
    x32 = x.float()
    sq = x32 * x32
    if row_order:
        var = router_ops.row_sum(sq) / x.shape[-1]
    else:
        var = sq.mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope ----

def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,) or broadcastable."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ----

def _qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         row_order: bool = False):
    """q, k, v (B, H, S, hd) after qk_norm and RoPE; ``row_order`` (decode)
    sums qk_norm's squares in one order a row (:func:`rmsnorm`)."""
    B, S, _ = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    cd = x.dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(B, S, Hq, hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps, row_order=row_order)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps, row_order=row_order)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _narrow_operands(k: torch.Tensor) -> bool:
    """Whether :func:`chunked_attention` multiplies ``k``'s dtype as it is:
    bf16 / f16 on a CUDA device (whose ``torch.bmm`` takes ``out_dtype``)."""
    return k.device.type == "cuda" and k.dtype in (torch.bfloat16,
                                                   torch.float16)


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, chunk: int = 1024):
    """Online softmax over KV chunks.  q: (B, Hq, Sq, hd); k/v: (B, Hkv,
    Skv, hd).  Operands stay in their narrow dtype, products and sums are
    f32, and the GQA group rides along q's head dim (no K/V repeat).

    On a CUDA device with bf16 / f16 k and v both products run on the
    narrow operands with f32 outputs (``torch.bmm(..., out_dtype=float32)``,
    as the reference's ``preferred_element_type``); f32 operands and CPU
    tensors (which have no ``bmm.dtype`` kernel) widen to f32 first, which
    gives the same products since a narrow product is exact in f32."""
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = hd ** -0.5
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    n_chunks = (Skv + pad) // chunk
    narrow = _narrow_operands(k)
    qg = (q * scale).to(k.dtype).reshape(B, Hkv, g, Sq, hd)
    if narrow:
        qg = qg.reshape(B * Hkv, g * Sq, hd)
    else:
        qg = qg.float()
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, hd), device=dev)
    for ci in range(n_chunks):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        if narrow:
            s = torch.bmm(qg, kb.reshape(B * Hkv, chunk, hd).transpose(1, 2),
                          out_dtype=torch.float32
                          ).view(B, Hkv, g, Sq, chunk)
        else:
            s = torch.matmul(qg, kb[:, :, None].float().transpose(-1, -2))
        k_pos = ci * chunk + torch.arange(chunk, device=dev)[None, :]
        mask = k_pos < Skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if narrow:
            pv = torch.bmm(p.to(v.dtype).reshape(B * Hkv, g * Sq, chunk),
                           vb.reshape(B * Hkv, chunk, hd),
                           out_dtype=torch.float32).view(B, Hkv, g, Sq, hd)
        else:
            pv = torch.matmul(p.to(v.dtype).float(), vb[:, :, None].float())
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


@functools.lru_cache(maxsize=16)
def _layer_mask(spec: AttnMaskSpec, S: int, window: Optional[int], bq: int,
                bk: int):
    """The spec's mask for a prefill of S tokens, built once and shared by
    every layer of that geometry."""
    return spec.build(S, S, layer_window=window, bq=bq, bk=bk)


def _masked_prefill_attention(q, k, v, spec: AttnMaskSpec,
                              window: Optional[int]):
    """Prefill through the masked flash kernels when the spec applies to
    this layer (sliding-window layers via ``spec.local``, full-attention
    layers via ``spec.pattern``); None -> the caller takes its ``impl``.
    Tiles not given by the spec come from the ``flash`` row of the device's
    tuning table."""
    S, D = q.shape[2], q.shape[3]
    bq, bk = spec.bq, spec.bk
    if bq is None or bk is None:
        tbq, tbk = tuning.flash_tiles(S, S, D, q.dtype, q.device)
        bq, bk = bq or tbq, bk or tbk
    mask = _layer_mask(spec, S, window, bq, bk)
    if mask is None:
        return None
    return fops.attention(q, k, v, mask=mask, mask_impl=spec.impl)


def apply_attention(p, x: torch.Tensor, cfg: ArchConfig, *,
                    window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    impl: str = "chunked", cache=None,
                    cache_len=None, collect_kv: int = 0,
                    kv_quant: Optional[str] = None,
                    attn_mask: Optional[AttnMaskSpec] = None):
    """Self-attention (prefill) or one-step decode when ``cache`` is given.

    Prefill: ``impl`` is "chunked" | "kernel" | "ref"; ``attn_mask`` (an
    ``AttnMaskSpec``) takes precedence where it applies.  ``collect_kv`` > 0
    also returns a fresh cache of that capacity holding this call's
    keys/values; with a ``window`` and ``S >= window`` that cache is the
    ring of the last ``window`` positions, each at slot ``pos % window``
    (the reference's ``argsort``).  Decode ignores ``impl`` and
    ``attn_mask``, as in the reference, and sums qk_norm's squares in row
    order (:func:`rmsnorm`).  A decode cache of exactly ``window``
    positions is a ring (the reference's ``_decode_block_attn``): the new
    key / value goes to slot ``pos % window`` and every filled slot is
    visible (``kv_len = min(pos + 1, window)``, no window); a longer one
    is a full cache under the window.
    cache: dict(k=(B, Hkv, L, hd), v=...) -- **updated in place**: decode
    writes the new key/value at ``cache_len`` and returns the same dict.
    ``cache_len`` is a Python int, the fill of every row, or a ``(B,)`` int
    tensor of per-row fills (continuous batching: RoPE, the write and the
    attention's length run at each row's own position; at equal positions
    the values are those of the int).
    ``kv_quant`` (a narrow dtype name; full-context layers only, as in the
    reference): the collected cache is stored per position as narrow
    values and f32 scales over head_dim (``k`` / ``k_scale``, ``v`` /
    ``v_scale``; ``precision.quantize_rows``).  Decode knows a quantized
    cache by its ``k_scale`` leaf: the new key / value is quantized the
    same way and written with its scales, then the whole cache is
    dequantized to q's dtype for ``decode_attention``.  Neither reads
    anything back to the host (the quantizer's non-finite check is off,
    as the reference's is under jit), so a decode step can be captured.
    Returns (out, new_cache)."""
    if impl not in ("chunked", "kernel", "ref"):
        raise NotImplementedError(
            f"apply_attention impl={impl!r}: 'chunked', 'kernel' and 'ref' "
            "are ported")
    B, S, _ = x.shape
    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q, k, v = _qkv(p, x, cfg, positions)
        out = None
        if attn_mask is not None:
            out = _masked_prefill_attention(q, k, v, attn_mask, window)
        if out is None:
            if impl == "kernel":
                out = fops.attention(q, k, v, causal=True, window=window)
            elif impl == "chunked":
                out = chunked_attention(q, k, v, causal=True, window=window)
            else:
                out = attention_ref(q, k, v, causal=True, window=window)
        new_cache = None
        if collect_kv:
            if window and S >= window:
                # the ring: the last `window` positions at their slots
                # (pos % window), one permutation built on the device
                order = torch.argsort(positions[-window:] % window)
                kc, vc = (t[:, :, -window:].index_select(2, order)
                          for t in (k, v))
            else:
                cap = min(collect_kv, window) if window else collect_kv
                kc, vc = (F.pad(t, (0, 0, 0, cap - S)) for t in (k, v))
            if kv_quant is not None and not window:
                (qk, sk), (qv, sv) = (precision.quantize_rows(
                    t, kv_quant, check=False) for t in (kc, vc))
                new_cache = {"k": qk, "k_scale": sk, "v": qv, "v_scale": sv}
            else:
                new_cache = {"k": kc, "v": vc}
    else:
        if S != 1:
            raise ValueError(f"apply_attention decode takes one token, got {S}")
        quant = "k_scale" in cache
        # a local layer's cache of exactly `window` slots is a ring: the
        # write at slot pos % window, every filled slot visible
        ring = bool(window) and cache["k"].shape[2] == window
        if isinstance(cache_len, torch.Tensor):
            pos = cache_len.reshape(B).long()
            q, k1, v1 = _qkv(p, x, cfg, pos[:, None, None], row_order=True)
            # (row b, every head, slot of pos[b]) <- (B, Hkv, hd)
            at = (torch.arange(B, device=x.device), slice(None),
                  pos % window if ring else pos)
            kv_len = pos.clamp(max=window - 1) + 1 if ring else pos + 1
        else:
            pos = cache_len
            q, k1, v1 = _qkv(p, x, cfg,
                             torch.full((1,), pos, device=x.device),
                             row_order=True)
            at = (slice(None), slice(None), pos % window if ring else pos)
            kv_len = min(pos + 1, window) if ring else pos + 1
        for name, new in (("k", k1[:, :, 0]), ("v", v1[:, :, 0])):
            if quant:
                qn = precision.quant_name(cache[name].dtype)
                new, cache[name + "_scale"][at] = precision.quantize_rows(
                    new, qn, check=False)
            cache[name][at] = new.to(cache[name].dtype)
        kc, vc = cache["k"], cache["v"]
        if quant:
            kc, vc = (precision.dequantize_rows(cache[n], cache[n + "_scale"],
                                                q.dtype) for n in ("k", "v"))
        out = fops.decode_attention(q, kc, vc, kv_len=kv_len,
                                    window=None if ring else window)
        new_cache = cache
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(out.dtype), new_cache


# ------------------------------------------------------------------- mlp ----

def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    cd = x.dtype
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cd)) * (x @ p["w_up"].to(cd))
    else:  # squared_relu (Nemotron-4)
        h = torch.square(F.relu(x @ p["w_up"].to(cd)))
    return h @ p["w_down"].to(cd)
