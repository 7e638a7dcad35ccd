"""Model assembly for serving: params, decode caches, layered prefill/decode.

The port of the serving half of ``repro/models/model.py`` for the block
kinds ``attn`` and ``attn+moe``.  The stack is ``block_unit * n_repeats``;
per-slot params and caches are stacked along a leading repeat dim, as in the
reference, so ``params["blocks"][slot][...][i]`` is layer ``i`` of that slot
(a view: no copy).  The repeat loop runs in Python layer by layer, which is
what lets the serving loop interleave host routing between layers.

Caches are updated **in place**: decode writes each layer's new key/value
and MoE occupancy into the stacked cache tensors and returns the same dict.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.core.precision import policy as precision_policy
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

KINDS = ("attn", "attn+moe")


def _check_kinds(cfg: ArchConfig) -> None:
    bad = [k for k in cfg.block_unit if k not in KINDS]
    if bad or cfg.n_prologue or cfg.shared_attn_every or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: only stacks of {KINDS} without prologue, shared "
            f"attention or frontend are ported (got block_unit="
            f"{cfg.block_unit})")


# ---------------------------------------------------------------- init ------

def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random params with the reference's scales (N(0, 1) * d**-0.5, and
    d_ff**-0.5 for the down projections), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``.  Matmul weights are stored in the
    policy's compute dtype; norm scales and routers stay f32."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    cd = precision_policy(cfg.policy).compute_dtype
    g = torch.Generator(device=dev).manual_seed(seed)
    d, V, n = cfg.d_model, cfg.padded_vocab, cfg.n_repeats
    p: Params = {
        "embed": L.normal(g, (V, d), d ** -0.5, n=1, dtype=cd, device=dev)[0],
        "final_norm": {"scale": torch.ones(d, device=dev)},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal(g, (d, V), d ** -0.5, n=1, dtype=cd,
                                device=dev)[0]
    slots = []
    for kind in cfg.block_unit:
        kw = dict(n=n, dtype=cd, device=dev)
        slot = {"ln1": L.init_rmsnorm(d, n=n, device=dev),
                "attn": L.init_attention(g, cfg, **kw),
                "ln2": L.init_rmsnorm(d, n=n, device=dev)}
        slot["ffn"] = (moe.init_moe(g, cfg, **kw) if kind == "attn+moe"
                       else L.init_mlp(g, cfg, **kw))
        slots.append(slot)
    p["blocks"] = tuple(slots)
    return p


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zeroed stacked decode caches, one entry per slot: attention K/V
    ``(n_repeats, B, Hkv, max_seq, hd)`` and, for attn+moe slots, the
    routing occupancy ``(n_repeats, B, E)`` int32."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    shp = (cfg.n_repeats, batch, cfg.n_kv_heads, max_seq, cfg.hd)
    slots = []
    for kind in cfg.block_unit:
        c = {"attn": {"k": torch.zeros(shp, dtype=dtype, device=dev),
                      "v": torch.zeros(shp, dtype=dtype, device=dev)}}
        if kind == "attn+moe":
            c["moe"] = torch.zeros((cfg.n_repeats, batch, cfg.n_experts),
                                   dtype=torch.int32, device=dev)
        slots.append(c)
    return {"slots": tuple(slots)}


def check_cache_fits(cache, pos: int, *, who: str = "decode_step") -> None:
    """Raise when a decode write at ``pos`` would fall past the cache."""
    cap = min(c["attn"]["k"].shape[3] for c in cache["slots"])
    if pos >= cap:
        raise ValueError(
            f"{who}: KV-cache overflow -- write position {pos} >= cache "
            f"capacity {cap} (max_seq); grow max_seq or stop the sequence.")


# --------------------------------------------------------------- blocks -----

def _take(tree, i: int):
    """Layer ``i`` of a stacked param/cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _block(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, *,
           moe_fn: Callable, cache=None, pos: Optional[int] = None,
           collect_kv: int = 0, impl: str = "chunked",
           attn_mask: Optional[AttnMaskSpec] = None):
    """One attn / attn+moe sub-layer; ``impl`` and ``attn_mask`` reach its
    prefill attention.  Returns (x, new_cache)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, new_attn = L.apply_attention(
        p["attn"], h, cfg, impl=impl,
        cache=None if cache is None else cache["attn"], cache_len=pos,
        collect_kv=collect_kv, attn_mask=attn_mask)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    new_cache = {"attn": new_attn}
    if kind == "attn+moe":
        f, counts = moe_fn(p["ffn"], h, cfg,
                           counts=None if cache is None else cache["moe"],
                           pos=pos)
        if cache is None:
            new_cache["moe"] = counts
        else:
            cache["moe"].copy_(counts)
            new_cache["moe"] = cache["moe"]
    else:
        f = L.apply_mlp(p["ffn"], h, cfg)
    return x + f, new_cache


def final_logits(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 last_only: bool) -> torch.Tensor:
    """Final rmsnorm + unembedding, f32 logits (``last_only``: the trailing
    position only, the prefill contract)."""
    if last_only:
        x = x[:, -1:]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ unemb.to(x.dtype)).float()


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig):
    cd = precision_policy(cfg.policy).compute_dtype
    return params["embed"][tokens].to(cd)


def prefill_layered(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                    max_seq: int, cache_dtype=torch.bfloat16,
                    moe_fn: Optional[Callable] = None, impl: str = "chunked",
                    attn_mask: Optional[AttnMaskSpec] = None
                    ) -> Tuple[torch.Tensor, Params, int]:
    """Serving prefill, layer by layer.  ``moe_fn`` (signature of
    ``moe.apply_moe``) runs every attn+moe block's FFN with ``counts=None,
    pos=None`` -- a fresh sequence at position 0; the serving loop injects
    its route-then-execute stage here.  ``impl`` ("chunked" | "kernel" |
    "ref") and ``attn_mask`` (an ``AttnMaskSpec``) reach every attention
    layer.  Returns (last-position logits (B, 1, V) f32, decode cache filled
    to the prompt length with K/V in ``cache_dtype``, next position)."""
    _check_kinds(cfg)
    moe_fn = moe_fn or moe.apply_moe
    x = _embed(params, tokens, cfg)
    per_slot = [[] for _ in cfg.block_unit]
    for i in range(cfg.n_repeats):
        for slot, kind in enumerate(cfg.block_unit):
            x, c = _block(kind, _take(params["blocks"][slot], i), x, cfg,
                          moe_fn=moe_fn, collect_kv=max_seq, impl=impl,
                          attn_mask=attn_mask)
            per_slot[slot].append(c)
    logits = final_logits(params, x, cfg, last_only=True)
    slots = []
    for caches in per_slot:
        c = {"attn": {k: torch.stack([ci["attn"][k] for ci in caches]
                                     ).to(cache_dtype) for k in ("k", "v")}}
        if "moe" in caches[0]:
            c["moe"] = torch.stack([ci["moe"] for ci in caches])
        slots.append(c)
    return logits, {"slots": tuple(slots)}, tokens.shape[1]


def decode_step_layered(params: Params, cfg: ArchConfig, cache, pos: int,
                        tokens_1: torch.Tensor, *,
                        moe_fn: Optional[Callable] = None
                        ) -> Tuple[torch.Tensor, Params]:
    """One-token decode at position ``pos`` (a Python int, the fill of every
    row), layer by layer, with ``moe_fn`` threaded to every attn+moe block
    as in :func:`prefill_layered`.  ``pos`` is checked against the cache
    capacity first.  Updates ``cache`` in place; returns (logits (B, 1, V)
    f32, cache)."""
    check_cache_fits(cache, pos, who="decode_step_layered")
    moe_fn = moe_fn or moe.apply_moe
    x = _embed(params, tokens_1, cfg)
    for i in range(cfg.n_repeats):
        for slot, kind in enumerate(cfg.block_unit):
            x, _ = _block(kind, _take(params["blocks"][slot], i), x, cfg,
                          moe_fn=moe_fn, cache=_take(cache["slots"][slot], i),
                          pos=pos)
    return final_logits(params, x, cfg, last_only=False), cache
