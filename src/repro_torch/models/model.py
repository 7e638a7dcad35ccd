"""Model assembly for serving: params, decode caches, prefill and decode.

The port of the serving half of ``repro/models/model.py`` for the block
kinds ``attn``, ``attn_local``, ``attn_global``, ``attn+moe``, ``rwkv`` and
``mamba``, with the zamba-style ``prologue`` (``n_prologue`` layers of the
first kind before the stack, params and caches stacked over them) and
``shared_attn`` block (one unstacked attention block run after every
``shared_attn_every``-th repeat, its decode cache a slot of its own after
the block unit's, stacked over the repeats).
A config with a ``frontend`` ("audio" / "vision", the reference's stubs)
takes precomputed ``(B, frontend_tokens, d_model)`` embeddings at prefill,
prepended to the token embeddings; decode then runs on from the position
after them.
An ``attn_local`` layer attends over the config's ``local_window``; its
decode cache is a ring buffer of ``min(max_seq, local_window)`` slots,
position ``p`` at slot ``p % local_window`` (:func:`init_cache`).  The
stack is ``block_unit * n_repeats``; per-slot params and caches are stacked
along a leading repeat dim, as in the reference, so
``params["blocks"][slot][...][i]`` is layer ``i`` of that slot (a view: no
copy).  The repeat loop runs in Python layer
by layer, which is what lets the serving loop interleave host routing
between layers (``prefill_layered`` / ``decode_step_layered``).

The fused entry points :func:`prefill` and :func:`decode_step` run the same
loops with each attn+moe layer's MoE as one ``moe.apply_moe`` call, the
bcsr stream the full grid built on the device; :func:`decode_step` at a
device position tensor reads nothing on the host, so the serving loop can
capture it as one CUDA graph (``launch.serve``).

Caches are updated **in place**: decode writes each layer's new key/value,
MoE occupancy, RWKV state and token shifts, and Mamba conv carry and SSM
state into the stacked cache tensors and returns the same dict.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch import resolve_device, tree
from repro_torch.core import precision
from repro_torch.core.masks import NEG_INF, AttnMaskSpec
from repro_torch.core.precision import QuantTensor
from repro_torch.core.precision import policy as precision_policy
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.config import ArchConfig
from repro_torch.parallel import collectives as tp
from repro_torch.parallel import context
from repro_torch.parallel.sharding import data_axis_size

Params = Dict[str, Any]

KINDS = ("attn", "attn_local", "attn_global", "attn+moe", "rwkv", "mamba")
# the reference's frontend stubs: precomputed (B, frontend_tokens, d_model)
# embeddings prepended to the token embeddings (``prefill(embeddings=)``)
FRONTENDS = ("none", "audio", "vision")


def _check_kinds(cfg: ArchConfig) -> None:
    bad = [k for k in cfg.block_unit if k not in KINDS]
    if bad or cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: only stacks of {KINDS} with a frontend of "
            f"{FRONTENDS} are ported (got block_unit={cfg.block_unit}, "
            f"frontend={cfg.frontend!r})")


def _fires(cfg: ArchConfig, i: int) -> bool:
    """Whether the shared attention block advances the residual after
    repeat ``i`` (the reference's fire test)."""
    return i % cfg.shared_attn_every == cfg.shared_attn_every - 1


def step_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """The kind of every layer one decode step runs, in order: the
    prologue's, then each repeat's block unit followed by the shared
    attention block where it fires."""
    kinds = (cfg.block_unit[0],) * cfg.n_prologue
    for i in range(cfg.n_repeats):
        kinds += cfg.block_unit
        if cfg.shared_attn_every and _fires(cfg, i):
            kinds += ("shared_attn",)
    return kinds


def _cache_slots(cfg: ArchConfig, cache):
    """(cache slot, kind) of every stacked slot of a decode cache: the
    block unit's, the shared block's, and the prologue's."""
    out = list(zip(cache["slots"], _cache_kinds(cfg)))
    if cfg.n_prologue:
        out.append((cache["prologue"], cfg.block_unit[0]))
    return out


def _window_for(kind: str, cfg: ArchConfig) -> Optional[int]:
    """The attention window of a layer of ``kind``: the config's
    ``local_window`` for ``attn_local``, else None (full context)."""
    return cfg.local_window if kind == "attn_local" else None


# ---------------------------------------------------------------- init ------

def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                param_dtype: Optional[torch.dtype] = None) -> Params:
    """Random params with the reference's scales (N(0, 1) * d**-0.5, and
    d_ff**-0.5 for the down projections), drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device``.  Matmul weights are stored in
    ``param_dtype``, by default the policy's compute dtype (serving: every
    use casts to it anyway); training stores them in f32, the reference's
    init dtype (``param_dtype=torch.float32``), and every use casts to the
    compute dtype.  Norm scales and routers stay f32."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    cd = param_dtype or precision_policy(cfg.policy).compute_dtype
    # on "meta" (shapes and dtypes only) there is nothing to draw
    g = (None if dev.type == "meta" else
         torch.Generator(device=dev).manual_seed(seed))
    d, V, n = cfg.d_model, cfg.padded_vocab, cfg.n_repeats
    p: Params = {
        "embed": L.normal(g, (V, d), d ** -0.5, n=1, dtype=cd, device=dev)[0],
        "final_norm": {"scale": torch.ones(d, device=dev)},
    }
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal(g, (d, V), d ** -0.5, n=1, dtype=cd,
                                device=dev)[0]
    p["blocks"] = tuple(init_block(g, kind, cfg, n=n, dtype=cd, device=dev)
                        for kind in cfg.block_unit)
    if cfg.shared_attn_every:      # one unstacked weight set
        p["shared_attn"] = _take(init_block(g, "shared_attn", cfg, n=1,
                                            dtype=cd, device=dev), 0)
    if cfg.n_prologue:
        p["prologue"] = init_block(g, cfg.block_unit[0], cfg,
                                   n=cfg.n_prologue, dtype=cd, device=dev)
    return p


def init_block(g: torch.Generator, kind: str, cfg: ArchConfig, *, n: int,
               dtype, device) -> Params:
    """``n`` stacked layers of ``kind`` drawn from ``g``, matmul weights in
    ``dtype``: the reference's ``init_block`` tree with a leading layer
    dim."""
    d = cfg.d_model
    kw = dict(n=n, dtype=dtype, device=device)
    if kind == "rwkv":
        return {"ln1": L.init_rmsnorm(d, n=n, device=device),
                "ln2": L.init_rmsnorm(d, n=n, device=device),
                "mixer": rwkv6.init_rwkv(g, cfg, **kw)}
    if kind == "mamba":
        return {"ln": L.init_rmsnorm(d, n=n, device=device),
                "mixer": mamba2.init_mamba(g, cfg, **kw)}
    slot = {"ln1": L.init_rmsnorm(d, n=n, device=device),
            "attn": L.init_attention(g, cfg, **kw),
            "ln2": L.init_rmsnorm(d, n=n, device=device)}
    slot["ffn"] = (moe.init_moe(g, cfg, **kw) if kind == "attn+moe"
                   else L.init_mlp(g, cfg, **kw))
    return slot


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, *,
               dtype=torch.bfloat16, device="cuda",
               kv_quant: Optional[str] = None) -> Params:
    """Zeroed stacked decode caches, one entry per slot: attention K/V
    ``(n_repeats, B, Hkv, L, hd)`` -- ``L`` is ``max_seq``, and for
    ``attn_local`` slots ``min(max_seq, local_window)``: a ring buffer when
    it equals the window (:func:`_window_for`) -- and, for attn+moe slots,
    the routing occupancy ``(n_repeats, B, E)`` int32; for rwkv slots the f32
    state ``wkv`` ``(n_repeats, B, nh, 64, 64)`` and the token shifts
    ``shift_t`` / ``shift_c`` ``(n_repeats, B, 1, d)`` in ``dtype``; for
    mamba slots the conv carry ``conv`` ``(n_repeats, B, K-1, d_in + 2 ns)``
    in ``dtype`` and the f32 state ``ssm`` ``(n_repeats, B, nh, hd, ns)``.
    A shared attention block's full-context K/V is one more slot after the
    block unit's, and ``prologue`` the first kind's cache stacked over the
    ``n_prologue`` layers.
    ``kv_quant`` (a narrow dtype name) makes the full-context K/V narrow
    zeros with per-position f32 scales ``k_scale`` / ``v_scale`` ``(n_repeats,
    B, Hkv, max_seq)`` of ones, the all-zero convention of
    ``precision.quantize_rows``, as the reference's ``init_cache`` does; the
    local slots stay wide."""
    _check_kinds(cfg)
    dev = resolve_device(device)
    kw = dict(batch=batch, max_seq=max_seq, dtype=dtype, device=dev,
              kv_quant=kv_quant)
    slots = [_slot_cache(cfg, kind, cfg.n_repeats, **kw)
             for kind in cfg.block_unit]
    if cfg.shared_attn_every:
        slots.append(_slot_cache(cfg, "shared_attn", cfg.n_repeats, **kw))
    out = {"slots": tuple(slots)}
    if cfg.n_prologue:
        out["prologue"] = _slot_cache(cfg, cfg.block_unit[0], cfg.n_prologue,
                                      **kw)
    return out


def _slot_cache(cfg: ArchConfig, kind: str, n: int, *, batch: int,
                max_seq: int, dtype, device, kv_quant: Optional[str]):
    """The zeroed decode cache of ``n`` stacked layers of ``kind``."""
    if kind == "rwkv":
        nh, hd = cfg.d_model // rwkv6.HEAD_DIM, rwkv6.HEAD_DIM
        shift = (n, batch, 1, cfg.d_model)
        return {"wkv": torch.zeros((n, batch, nh, hd, hd),
                                   dtype=torch.float32, device=device),
                "shift_t": torch.zeros(shift, dtype=dtype, device=device),
                "shift_c": torch.zeros(shift, dtype=dtype, device=device)}
    if kind == "mamba":
        d_in = cfg.ssm_expand * cfg.d_model
        ns, hd = cfg.ssm_state, cfg.ssm_head_dim
        conv = (n, batch, cfg.ssm_conv - 1, d_in + 2 * ns)
        return {"conv": torch.zeros(conv, dtype=dtype, device=device),
                "ssm": torch.zeros((n, batch, d_in // hd, hd, ns),
                                   dtype=torch.float32, device=device)}
    window = _window_for(kind, cfg)
    shp = (n, batch, cfg.n_kv_heads,
           min(max_seq, window) if window else max_seq, cfg.hd)
    if kv_quant is not None and not window:
        qdt = precision.QUANT_DTYPES[kv_quant]
        c = {"attn": {
            "k": torch.zeros(shp, dtype=qdt, device=device),
            "k_scale": torch.ones(shp[:-1], device=device),
            "v": torch.zeros(shp, dtype=qdt, device=device),
            "v_scale": torch.ones(shp[:-1], device=device)}}
    else:
        c = {"attn": {"k": torch.zeros(shp, dtype=dtype, device=device),
                      "v": torch.zeros(shp, dtype=dtype, device=device)}}
    if kind == "attn+moe":
        c["moe"] = torch.zeros((n, batch, cfg.n_experts), dtype=torch.int32,
                               device=device)
    return c


def blank_cache_row(cache, row: int):
    """Batch row ``row`` of a stacked decode cache back to its freshly
    made state, **in place**: zeros in every leaf of two or more dims,
    except the quantization scales ``k_scale`` / ``v_scale``, which go back
    to 1.0 (the all-zero convention of ``precision.quantize_rows``, as
    :func:`init_cache` makes them).  A scheduler blanks the row of a
    poisoned request it fails, so no NaN / Inf state reaches the next
    request admitted into it; every other row is untouched, and a captured
    decode graph over the cache sees the write.  Returns ``cache``."""

    def blank(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                blank(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                blank(v)
        elif node.dim() >= 2:
            node[:, row].fill_(1.0 if key in _SCALE_LEAVES else 0)

    blank(cache)
    return cache


def cache_capacity(cache, cfg: ArchConfig) -> Optional[int]:
    """Sequence capacity of a decode cache: the shortest attention K/V
    cache (the shared attention block's and the prologue's slots
    included), or None for a stack without one (recurrent state only, or
    ring buffers only), which never overflows.  A ring buffer (the cache of
    a layer whose :func:`_window_for` equals its length, the rule decode
    picks a ring by) wraps and is left out, as the reference's
    ``cache_capacity`` leaves out leaves of ``cfg.local_window``."""
    caps = [c["attn"]["k"].shape[3] for c, kind in _cache_slots(cfg, cache)
            if "attn" in c
            and c["attn"]["k"].shape[3] != _window_for(kind, cfg)]
    return min(caps) if caps else None


def check_cache_fits(cache, pos: int, cfg: ArchConfig, *,
                     who: str = "decode_step") -> None:
    """Raise when a decode write at ``pos`` would fall past the cache (its
    ring buffers left out: :func:`cache_capacity`)."""
    cap = cache_capacity(cache, cfg)
    if cap is not None and pos >= cap:
        raise ValueError(
            f"{who}: KV-cache overflow -- write position {pos} >= cache "
            f"capacity {cap} (max_seq); grow max_seq or stop the sequence.")


# --------------------------------------------------------------- blocks -----

def _take(tree, i: int):
    """Layer ``i`` of a stacked param/cache tree (views, no copy); a
    :class:`QuantTensor` leaf (quantized experts) keeps its negative axis,
    its values and scales each sliced."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantTensor):
        return QuantTensor(values=tree.values[i], scales=tree.scales[i],
                           axis=tree.axis)
    return tree[i]


def apply_block(kind: str, p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                impl: str = "chunked", cache=None, pos=None,
                collect_kv: int = 0, moe_fn: Optional[Callable] = None,
                kv_quant: Optional[str] = None,
                attn_mask: Optional[AttnMaskSpec] = None,
                route_ahead: bool = False, cache_axis=None):
    """One attn / attn_local / attn_global / attn+moe / shared_attn / rwkv /
    mamba sub-layer (the reference's ``apply_block``, its keywords), its
    window from :func:`_window_for`; ``impl``, ``attn_mask`` and
    ``kv_quant`` reach its prefill attention; ``moe_fn`` (default
    ``moe.apply_moe``) runs an attn+moe block's FFN.  ``route_ahead``: an
    attn+moe block runs MoE route phase 1 (``moe.route_phase1``) right
    after ``ln2``, with its attention half, and hands ``moe_fn`` the
    ``moe.Phase1`` as ``phase1``.
    Decode's ``pos`` is an int or a ``(B,)`` int tensor of per-row
    positions on ``x``'s device.  ``cache_axis``: the attention's (the mesh
    axis that splits the decode cache's sequence under a mesh).  Under the
    serving steps' MoE hints (``context.MOE_SPEC`` with a ``MESH``; a
    cache, or the KV collected) an attn+moe block routes this rank's rows
    of the replicated ``moe`` counts (B, E), those that
    ``context.ACT_SPEC``'s batch entry gives it, and all-gathers the rows'
    new counts over that entry, so every rank holds the whole leaf
    (``parallel.collectives.own_rows`` / ``all_rows``).  Returns
    (x, new_cache); decode (``cache`` given) writes the new cache entries
    into ``cache`` in place."""
    if kind == "rwkv":
        return _rwkv_block(p, x, cfg, cache=cache, collect=bool(collect_kv))
    dec = cache is not None                 # decode: norms in row order
    if kind == "mamba":
        h = L.rmsnorm(p["ln"], x, cfg.norm_eps, row_order=dec)
        m, new_cache = mamba2.apply_mamba(p["mixer"], h, cfg, cache=cache,
                                          collect=bool(collect_kv))
        return x + m, new_cache
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps, row_order=dec)
    a, new_attn = L.apply_attention(
        p["attn"], h, cfg, window=_window_for(kind, cfg), impl=impl,
        cache=None if cache is None else cache["attn"], cache_len=pos,
        collect_kv=collect_kv, attn_mask=attn_mask, kv_quant=kv_quant,
        cache_axis=cache_axis)
    x = x + a
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps, row_order=dec)
    new_cache = {"attn": new_attn}
    if kind == "attn+moe":
        counts = None if cache is None else cache["moe"]
        kw = {}
        mesh_rows = (context.MOE_SPEC is not None and context.MESH is not None
                     and (cache is not None or bool(collect_kv)))
        entry = context.ACT_SPEC[0] if mesh_rows else None
        if mesh_rows and counts is not None:
            counts = tp.own_rows(counts, entry)
        if route_ahead:
            pos0 = 0 if pos is None else pos
            cap = moe.dispatch_capacity(h.shape[1], cfg, pos0=pos0)
            kw["phase1"] = moe.Phase1(*moe.route_phase1(
                p["ffn"]["router"], h, cfg, counts, pos0, cap), cap)
        f, counts = (moe_fn or moe.apply_moe)(p["ffn"], h, cfg,
                                              counts=counts, pos=pos, **kw)
        if mesh_rows:
            counts = tp.all_rows(counts, entry)
        if cache is None:
            new_cache["moe"] = counts
        else:
            cache["moe"].copy_(counts)
            new_cache["moe"] = cache["moe"]
    else:
        f = L.apply_mlp(p["ffn"], h, cfg)
    return x + f, new_cache


def _rwkv_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *, cache,
                collect: bool):
    """Time mix then channel mix, each on its rmsnorm and residual (in
    row order when decoding)."""
    dec = cache is not None
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps, row_order=dec)
    t_cache = (None if cache is None else
               {"shift_t": cache["shift_t"], "wkv": cache["wkv"]})
    t, new_t = rwkv6.apply_rwkv_time(p["mixer"], h, cfg, cache=t_cache,
                                     collect=collect)
    x = x + t
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps, row_order=dec)
    c_cache = None if cache is None else {"shift_c": cache["shift_c"]}
    c, new_c = rwkv6.apply_rwkv_channel(p["mixer"], h, cfg, cache=c_cache,
                                        collect=collect)
    x = x + c
    new = None if new_t is None else {**new_t, **new_c}
    if cache is not None:
        for key, val in new.items():
            if val is not cache[key]:       # the state was stepped in place
                cache[key].copy_(val)
        new = cache
    return x, new


def final_logits(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 last_only: bool, row_order: bool = False) -> torch.Tensor:
    """Final rmsnorm + unembedding, f32 logits (``last_only``: the trailing
    position only, the prefill contract; ``row_order``: the decode step's
    norm, see ``layers.rmsnorm``).  Under ``context.ACT_SPEC`` the logits
    are this rank's vocabulary slice, and under sequence parallelism the
    trailing position is the last "model" rank's
    (``collectives.last_position``)."""
    if last_only:
        x = tp.last_position(x)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps, row_order=row_order)
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ unemb.to(x.dtype)).float()


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
           embeddings: Optional[torch.Tensor] = None):
    """The token embeddings in the compute dtype, after ``embeddings``
    (B, F, d_model) when given: cast to the compute dtype first (one
    round to nearest even), then concatenated, as the reference does."""
    cd = precision_policy(cfg.policy).compute_dtype
    if tp.active():     # this rank's vocabulary rows, summed over "model"
        if embeddings is not None:
            raise ValueError("frontend embeddings under a mesh are not "
                             "ported (ROADMAP Queue 1 item 4b.5)")
        return tp.vocab_embed(params["embed"], tokens).to(cd)
    x = params["embed"][tokens].to(cd)
    if embeddings is not None:
        x = torch.cat([embeddings.to(cd), x], dim=1)
    return x


# ----------------------------------------------------------- training ------

def _layers(stacked, n: int) -> list:
    """The ``n`` layers of a stacked param tree as ``n`` trees of views,
    through one ``unbind`` a leaf: the backward stacks the layers'
    gradients into the leaf's once, where a view a layer (``_take``) would
    write a zero-padded copy of the whole leaf for every layer."""
    unbound = [t.unbind(0) for t in tree.leaves(stacked)]
    return [tree.unflatten(stacked, [u[i] for u in unbound])
            for i in range(n)]


def _superblock(p_slots, x: torch.Tensor, cfg: ArchConfig, impl: str,
                shared_p, fire: bool,
                layer_params: Optional[Callable] = None) -> torch.Tensor:
    """One repeat of the block unit, then the shared attention block where
    it fires (the reference's ``_superblock`` without caches);
    ``layer_params`` as in :func:`hidden_forward`."""
    for j, (kind, p) in enumerate(zip(cfg.block_unit, p_slots)):
        if layer_params is not None:
            p = layer_params(j, p)
        x, _ = apply_block(kind, p, x, cfg, impl=impl)
    if fire:
        x, _ = apply_block("shared_attn", shared_p, x, cfg, impl=impl)
    return x


def hidden_forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                   embeddings: Optional[torch.Tensor] = None,
                   impl: str = "chunked", remat: bool = True,
                   layer_params: Optional[Callable] = None
                   ) -> torch.Tensor:
    """Backbone forward of training: the embeddings (after ``embeddings``
    (B, F, d) where given), the prologue layers, the stacked superblocks,
    the final norm.  Returns the normed hidden states (B, S_total, d) in
    the compute dtype.  ``remat``: each prologue layer and each superblock
    (the shared block's firing included) runs under
    ``torch.utils.checkpoint`` (non-reentrant), as the reference wraps its
    scan body in ``jax.checkpoint``: only the residual between superblocks
    is kept, the rest is recomputed in the backward.  ``layer_params(slot,
    p)``, where given, makes the tree a superblock's layer runs on from its
    slice ``p`` of ``params["blocks"][slot]``, inside the superblock's
    remat, so the backward reruns it too: the sharded train step gathers a
    layer's FSDP shards there, and only one superblock's gathered weights
    are live at a time."""
    _check_kinds(cfg)

    def run(fn, *args):
        if remat:
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        return fn(*args)

    x = _embed(params, tokens, cfg, embeddings)
    if cfg.n_prologue:
        kind = cfg.block_unit[0]
        for p in _layers(params["prologue"], cfg.n_prologue):
            x = run(lambda p, x: apply_block(kind, p, x, cfg, impl=impl)[0],
                    p, x)
    slots = [_layers(s, cfg.n_repeats) for s in params["blocks"]]
    shared_p = params.get("shared_attn")
    for i in range(cfg.n_repeats):
        fire = bool(cfg.shared_attn_every) and _fires(cfg, i)
        x = run(functools.partial(_superblock, cfg=cfg, impl=impl,
                                  shared_p=shared_p, fire=fire,
                                  layer_params=layer_params),
                tuple(s[i] for s in slots), x)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _unembedding(params: Params, cfg: ArchConfig, dtype) -> torch.Tensor:
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return unemb.to(dtype)


def forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            embeddings: Optional[torch.Tensor] = None, impl: str = "chunked",
            remat: bool = True) -> torch.Tensor:
    """Train forward: tokens (B, S_text) int, optional frontend
    ``embeddings`` (B, S_front, d) prepended.  Returns the logits (B,
    S_total, V) f32, the padded vocabulary included."""
    x = hidden_forward(params, tokens, cfg, embeddings=embeddings, impl=impl,
                       remat=remat)
    return (x @ _unembedding(params, cfg, x.dtype)).float()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            embeddings: Optional[torch.Tensor] = None, impl: str = "chunked",
            seq_chunk: Optional[int] = None,
            layer_params: Optional[Callable] = None) -> torch.Tensor:
    """Next-token cross-entropy over the token region (the frontend
    positions dropped), padded vocabulary ids masked with ``NEG_INF``; a ()
    f32 tensor.  ``seq_chunk``: the logits and the cross-entropy a chunk of
    that many positions at a time, each under ``torch.utils.checkpoint``, so
    the (B, S, V) logits never exist (the tail past the last whole chunk is
    one more piece).  Under ``parallel.context.LOGIT_SPEC`` (the sharded
    train step) ``tokens`` are this rank's rows and ``params`` its "model"
    share: the hidden states of every position (gathered over "model"
    under sequence parallelism) against this rank's vocabulary columns,
    the vocab-parallel cross-entropy
    (``parallel.collectives.vocab_cross_entropy``), and this rank's part
    of the global batch's loss: its rows' sum over ``B * (S - 1)``, chunked
    or not.  ``layer_params``: :func:`hidden_forward`'s."""
    h = hidden_forward(params, tokens, cfg, embeddings=embeddings, impl=impl,
                       layer_params=layer_params)
    vocab_parallel = context.LOGIT_SPEC is not None
    if vocab_parallel:      # every position's hidden state, once a rank
        h = tp.enter(h)
    if embeddings is not None:
        h = h[:, embeddings.shape[1]:]
    h = h[:, :-1]
    tgt = tokens[:, 1:].long()
    unemb = _unembedding(params, cfg, h.dtype)
    pad = (torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
           if cfg.padded_vocab != cfg.vocab_size else None)

    def ce(h_blk, tgt_blk):
        logits = (h_blk @ unemb).float()
        if vocab_parallel:
            return tp.vocab_cross_entropy(logits, tgt_blk, cfg.vocab_size,
                                          NEG_INF)
        if pad is not None:
            logits = torch.where(pad, NEG_INF, logits)
        lp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(lp, -1, tgt_blk[..., None])[..., 0]

    B, Sm1 = h.shape[0], h.shape[1]
    if vocab_parallel:      # this rank's rows of the global batch
        B *= data_axis_size(context.MESH)
    if seq_chunk is None or seq_chunk >= Sm1:
        loss = ce(h, tgt)
        return loss.sum() / (B * Sm1) if vocab_parallel else loss.mean()
    total = torch.zeros((), device=h.device)
    for lo in range(0, Sm1 - Sm1 % seq_chunk, seq_chunk):
        sl = slice(lo, lo + seq_chunk)
        total = total + torch.utils.checkpoint.checkpoint(
            lambda hb, tb: ce(hb, tb).sum(), h[:, sl], tgt[:, sl],
            use_reentrant=False)
    if Sm1 % seq_chunk:
        tail = slice(Sm1 - Sm1 % seq_chunk, Sm1)
        total = total + ce(h[:, tail], tgt[:, tail]).sum()
    return total / (B * Sm1)


def _check_prompt_fits(cfg: ArchConfig, S_total: int, max_seq: int) -> None:
    """Raise when a prefill of ``S_total`` positions (frontend positions
    and prompt) would not fit an attention cache of ``max_seq``."""
    if S_total > max_seq and any(k not in ("rwkv", "mamba")
                                 for k in _cache_kinds(cfg)):
        raise ValueError(
            f"prefill: {S_total} positions (frontend + prompt) do not fit "
            f"max_seq {max_seq}; grow max_seq")


def prefill_layered(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
                    max_seq: int, cache_dtype=torch.bfloat16,
                    moe_fn: Optional[Callable] = None, impl: str = "chunked",
                    attn_mask: Optional[AttnMaskSpec] = None,
                    route_ahead: bool = False,
                    kv_quant: Optional[str] = None,
                    embeddings: Optional[torch.Tensor] = None,
                    layer_params: Optional[Callable] = None,
                    cache_axis=None) -> Tuple[torch.Tensor, Params, int]:
    """Serving prefill, layer by layer.  ``moe_fn`` (signature of
    ``moe.apply_moe``) runs every attn+moe block's FFN with ``counts=None,
    pos=None`` -- a fresh sequence at position 0; the serving loop injects
    its route-then-execute stage here.  ``impl`` ("chunked" | "kernel" |
    "ref") and ``attn_mask`` (an ``AttnMaskSpec``) reach every attention
    layer.  ``route_ahead=True`` (the pipelined serving path) runs MoE
    route phase 1 with each attn+moe block's attention half and passes the
    ``moe.Phase1`` to ``moe_fn`` as ``phase1``, at the prompt's dispatch
    capacity; the values are those of ``route_ahead=False``.
    ``kv_quant`` (a narrow dtype name) stores the collected K/V as narrow
    values with per-position f32 scales (``k_scale`` / ``v_scale``); the
    logits do not change.  ``embeddings`` (B, F, d_model), a frontend's
    precomputed patch or frame embeddings on the tokens' device, are cast
    to the compute dtype and prepended to the token embeddings; every layer
    (RoPE, masks, the caches) then sees ``S_total = F + S`` positions.
    ``layer_params(slot, p)``, where given, makes the tree a stacked layer
    runs on from its slice ``p`` (the serving step on a mesh gathers the
    layer's FSDP shards there); ``cache_axis`` as ``apply_block``'s.
    Returns (last-position logits (B, 1, V) f32, decode cache filled to
    S_total with K/V in ``cache_dtype`` or quantized, the next position
    S_total)."""
    _check_kinds(cfg)
    moe_fn = moe_fn or moe.apply_moe
    kw = dict(moe_fn=moe_fn, collect_kv=max_seq, impl=impl,
              attn_mask=attn_mask, route_ahead=route_ahead,
              kv_quant=kv_quant, cache_axis=cache_axis)
    x = _embed(params, tokens, cfg, embeddings)
    # (under sequence parallelism x is this rank's block of the positions)
    S_total = tokens.shape[1] + (0 if embeddings is None
                                 else embeddings.shape[1])
    _check_prompt_fits(cfg, S_total, max_seq)
    prologue = []
    for i in range(cfg.n_prologue):
        x, c = apply_block(cfg.block_unit[0], _take(params["prologue"], i), x,
                           cfg, **kw)
        prologue.append(c)
    per_slot = [[] for _ in _cache_kinds(cfg)]
    for i in range(cfg.n_repeats):
        for slot, kind in enumerate(cfg.block_unit):
            p = _take(params["blocks"][slot], i)
            if layer_params is not None:
                p = layer_params(slot, p)
            x, c = apply_block(kind, p, x, cfg, **kw)
            per_slot[slot].append(c)
        if cfg.shared_attn_every:
            # the cache is collected every repeat, as the reference's; the
            # residual takes the block's output on fire steps only
            y2, c = apply_block("shared_attn", params["shared_attn"], x, cfg,
                                **kw)
            if _fires(cfg, i):
                x = y2
            per_slot[-1].append(c)
    logits = final_logits(params, x, cfg, last_only=True)
    cd = precision_policy(cfg.policy).compute_dtype
    cache = {"slots": tuple(_cache_to_dtype(_stack(caches), cd, cache_dtype)
                            for caches in per_slot)}
    if prologue:
        cache["prologue"] = _cache_to_dtype(_stack(prologue), cd,
                                            cache_dtype)
    return logits, cache, S_total


def _cache_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """The kind of each slot of ``cache["slots"]``: the block unit's, then
    the shared attention block's."""
    return cfg.block_unit + (("shared_attn",) if cfg.shared_attn_every
                             else ())


def _fused_moe(dispatch: Optional[str]) -> Callable:
    """The fused path's MoE stage: one ``moe.apply_moe`` call a layer, the
    bcsr stream the full grid built on the device."""
    return functools.partial(moe.apply_moe, dispatch=dispatch,
                             full_grid=True)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
            max_seq: int, cache_dtype=torch.bfloat16, impl: str = "chunked",
            attn_mask: Optional[AttnMaskSpec] = None,
            dispatch: Optional[str] = None,
            embeddings: Optional[torch.Tensor] = None,
            kv_quant: Optional[str] = None,
            layer_params: Optional[Callable] = None, cache_axis=None
            ) -> Tuple[torch.Tensor, Params, int]:
    """Serving prefill of the fused mode, the counterpart of the reference's
    ``model.prefill``: the whole stack with each attn+moe layer's MoE as one
    ``moe.apply_moe`` call with the ``dispatch`` backend (default: the
    config's), "bcsr" through the full-grid stream built on the device,
    never the host compaction.  The layer loop is
    :func:`prefill_layered`'s, ``kv_quant``, ``embeddings``,
    ``layer_params`` and ``cache_axis`` too.
    Returns (last-position logits (B, 1, V) f32, decode cache filled to
    the frontend positions and the prompt, leaves in the compute dtype
    become ``cache_dtype``, next position)."""
    return prefill_layered(params, tokens, cfg, max_seq=max_seq,
                           cache_dtype=cache_dtype,
                           moe_fn=_fused_moe(dispatch), impl=impl,
                           attn_mask=attn_mask, kv_quant=kv_quant,
                           embeddings=embeddings, layer_params=layer_params,
                           cache_axis=cache_axis)


def _stack(trees):
    """Per-layer cache trees -> one tree of tensors stacked on a leading
    layer dim."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


_SCALE_LEAVES = ("k_scale", "v_scale")


def _cache_to_dtype(tree, cd, cache_dtype):
    """The reference's rule (``model._cache_to_dtype``): every cache leaf
    in the compute dtype becomes ``cache_dtype``; others (MoE counts, the
    f32 RWKV and SSM states when the compute dtype is bf16, narrow K/V)
    stay as they are, and so do the quantized cache's f32 scales
    (``k_scale`` / ``v_scale``) under any policy.  Under the f32 policy
    this rounds the RWKV and SSM states to a bf16 cache too."""
    if isinstance(tree, dict):
        return {k: v if k in _SCALE_LEAVES else
                _cache_to_dtype(v, cd, cache_dtype)
                for k, v in tree.items()}
    return tree.to(cache_dtype) if tree.dtype == cd else tree


def to_decode_dtypes(cfg: ArchConfig, cache) -> Params:
    """Bring the rwkv and mamba leaves to the dtypes a decode step writes
    (the f32 states, the shifts and conv carries in the compute dtype),
    the prologue's too, once, in place in ``cache``; returns ``cache``.
    The reference's decode step returns them so (a prefill cache under the
    f32 policy holds them in bf16) and reads the narrower values widened,
    which this widening reproduces exactly.  A cache for
    :func:`decode_step` goes through this once, when it is made, since the
    step writes into its leaves and never reassigns one."""
    for slot, key, dtype in _decode_leaves(cfg, cache):
        if slot[key].dtype != dtype:
            slot[key] = slot[key].to(dtype)
    return cache


def _decode_leaves(cfg: ArchConfig, cache):
    """(slot dict, key, dtype a decode step writes) of every rwkv and mamba
    leaf, the prologue's included."""
    cd = precision_policy(cfg.policy).compute_dtype
    leaves = {"rwkv": (("wkv", torch.float32), ("shift_t", cd),
                       ("shift_c", cd)),
              "mamba": (("ssm", torch.float32), ("conv", cd))}
    for slot, kind in _cache_slots(cfg, cache):
        for key, dtype in leaves.get(kind, ()):
            yield slot, key, dtype


def _decode_layers(params: Params, cfg: ArchConfig, cache, pos,
                   tokens_1: torch.Tensor, moe_fn: Callable,
                   route_ahead: bool = False,
                   layer_params: Optional[Callable] = None,
                   cache_axis=None) -> torch.Tensor:
    """The decode layer loop shared by :func:`decode_step_layered` and
    :func:`decode_step`: ``pos`` an int or a ``(B,)`` int tensor on the
    tokens' device; writes ``cache`` in place; returns the logits.
    ``layer_params`` and ``cache_axis`` as :func:`prefill_layered`'s."""
    kw = dict(moe_fn=moe_fn, pos=pos, route_ahead=route_ahead,
              cache_axis=cache_axis)
    x = _embed(params, tokens_1, cfg)
    for i in range(cfg.n_prologue):
        x, _ = apply_block(cfg.block_unit[0], _take(params["prologue"], i), x,
                           cfg, cache=_take(cache["prologue"], i), **kw)
    for i in range(cfg.n_repeats):
        for slot, kind in enumerate(cfg.block_unit):
            p = _take(params["blocks"][slot], i)
            if layer_params is not None:
                p = layer_params(slot, p)
            x, _ = apply_block(kind, p, x, cfg,
                               cache=_take(cache["slots"][slot], i), **kw)
        if cfg.shared_attn_every and _fires(cfg, i):
            # off a fire step the shared block's cache row stays as it is
            x, _ = apply_block("shared_attn", params["shared_attn"], x, cfg,
                               cache=_take(cache["slots"][-1], i), **kw)
    return final_logits(params, x, cfg, last_only=False, row_order=True)


def decode_step_layered(params: Params, cfg: ArchConfig, cache, pos,
                        tokens_1: torch.Tensor, *,
                        moe_fn: Optional[Callable] = None,
                        route_ahead: bool = False
                        ) -> Tuple[torch.Tensor, Params]:
    """One-token decode at position ``pos``, layer by layer, with ``moe_fn``
    threaded to every attn+moe block as in :func:`prefill_layered`
    (``route_ahead`` too: phase 1 at the decode capacity, 1).  ``pos`` is a
    Python int, the fill of every row, or an int ``(B,)`` numpy vector of
    per-row fills (continuous batching: each row's RoPE, cache write,
    attention length and MoE keep test at its own position; at equal
    positions the values are those of the int).  The host keeps the vector
    (its largest entry is checked against the cache capacity first); the
    device gets one copy of it a step, uploaded without blocking the host
    (``moe._upload``) and shared by every layer.  Updates ``cache`` in
    place; returns (logits (B, 1, V) f32, cache)."""
    if isinstance(pos, (int, np.integer)):
        pos = last = int(pos)
    else:
        host = np.asarray(pos).reshape(-1)
        if host.shape != (tokens_1.shape[0],):
            raise ValueError(f"decode_step_layered: pos has shape "
                             f"{host.shape}, the batch is {tokens_1.shape[0]}")
        last = int(host.max())
        pos = moe._upload(host.astype(np.int64), tokens_1.device)
    check_cache_fits(cache, last, cfg, who="decode_step_layered")
    to_decode_dtypes(cfg, cache)
    logits = _decode_layers(params, cfg, cache, pos, tokens_1,
                            moe_fn or moe.apply_moe, route_ahead)
    return logits, cache


def decode_step(params: Params, cfg: ArchConfig, cache, pos,
                tokens_1: torch.Tensor, *, dispatch: Optional[str] = None,
                layer_params: Optional[Callable] = None, cache_axis=None
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode of the fused mode, the counterpart of the
    reference's ``model.decode_step``: each attn+moe layer's MoE one
    ``moe.apply_moe`` call with ``dispatch`` ("gather", or "bcsr" through
    the full-grid stream; default: the config's).  ``tokens_1``: (B, 1)
    int.  ``pos``, the write position:

    * an int or a ``(B,)`` numpy vector: checked against the cache capacity
      on the host first, as :func:`decode_step_layered` does;
    * an int tensor on the tokens' device, ``()`` or ``(B,)``: the step
      reads nothing on the host (no capacity check, as the reference skips
      it for traced positions; the caller checks), so it can be captured
      as a CUDA graph.

    Either way every layer takes the per-row path at a ``(B,)`` position
    vector on the device.  ``cache`` (leaves in the dtypes a step writes:
    :func:`to_decode_dtypes`, else ``ValueError``) is updated in place;
    ``layer_params`` and ``cache_axis`` as :func:`prefill_layered`'s (the
    serving step on a mesh passes a device position: the host check would
    read the local cache's capacity).  Returns (logits (B, 1, V) f32,
    cache)."""
    B = tokens_1.shape[0]
    if isinstance(pos, torch.Tensor):
        if pos.device != tokens_1.device or pos.is_floating_point() \
                or pos.numel() not in (1, B) or pos.dim() > 1:
            raise ValueError(
                f"decode_step: pos {tuple(pos.shape)} {pos.dtype} on "
                f"{pos.device}; want an int () or ({B},) tensor on "
                f"{tokens_1.device}")
        pos = pos.reshape(-1).expand(B)
    else:
        host = np.broadcast_to(np.asarray(pos, np.int64).reshape(-1), (B,))
        check_cache_fits(cache, int(host.max()), cfg, who="decode_step")
        pos = torch.tensor(host, device=tokens_1.device)
    for slot, key, dtype in _decode_leaves(cfg, cache):
        if slot[key].dtype != dtype:
            raise ValueError(
                f"decode_step: cache leaf {key} is {slot[key].dtype}, a step "
                f"writes {dtype}; pass the cache through "
                "model.to_decode_dtypes once")
    logits = _decode_layers(params, cfg, cache, pos, tokens_1,
                            _fused_moe(dispatch), layer_params=layer_params,
                            cache_axis=cache_axis)
    return logits, cache
