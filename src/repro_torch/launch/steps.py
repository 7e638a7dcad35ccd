"""Step factories (``repro/launch/steps.py``): training on one device and
over the ranks of a mesh, and the serving steps over the ranks of a mesh.

:func:`make_train_step` returns ``train_step(params, opt_state, tokens,
embeddings=None) -> (params, opt_state, {"loss", "grad_norm"})``: the
value and gradient of ``model.loss_fn`` (remat a superblock, the
cross-entropy ``seq_chunk`` positions at a time), optionally over
``microbatches`` slices of the batch whose f32 gradients are summed and
divided by their number, as the reference's scan, then the optimizer's
update.  Numpy inputs go to the params' device.

With ``mesh=`` (a ``DeviceMesh`` of ``launch.mesh``, one rank a process)
it returns the reference's triple ``(train_step, (p_specs, o_specs,
tok_spec, emb_spec), (p_specs, o_specs, {"loss": P(), "grad_norm":
P()}))``, the specs entry for entry the reference's.  That step takes this
rank's part of the params and of AdamW's state (``parallel.sharding.
local_tree`` of the global trees by ``p_specs`` / ``o_specs``) and the
global tokens, the same on every rank; it cuts its rows by ``tok_spec``
and, inside ``parallel.context.activation_specs`` set as the reference's
step sets them:

* gathers each leaf over its FSDP axes (:func:`gather_params`; the
  matmul weights cast to the compute dtype first), a layer's inside its
  remat (:func:`layer_gather`), so the model sees the
  "model" share of every weight: heads, ``d_ff`` and the vocabulary split
  (tensor parallel), and, with ``seq_parallel``, the residual stream's
  sequence split over "model" between blocks (the reference's default);
* takes the value and gradient of its part of the loss, with
  microbatches as on one device; the collectives' backwards reduce the
  gradients to the shards;
* clips by the global norm (:func:`sharded_norm`: each element counted
  once over the ranks) and runs ``AdamW.update`` on the local shards.

It returns the new local shards, and a ``loss`` and ``grad_norm`` that are
equal on every rank.  An attn+moe layer runs the expert-parallel
``models.moe_shard_map.moe_block`` on the rank's block
(``moe_impl="shard_map"``).

The serving steps, :func:`make_prefill_step` and :func:`make_serve_step`,
return the reference's triples too; their steps take this rank's part of
the params (``param_specs``), the global tokens (each cuts its rows by
the tokens' spec) and, to decode, this rank's part of the decode cache
(``parallel.sharding.cache_specs`` of :func:`abstract_cache`).  They run
under ``torch.no_grad()`` and the hints the reference sets, gather a
layer's FSDP shards at the layer (:func:`layer_gather`), and never hold
the whole params or the whole cache.  The cache's sequence is split over
"model" when the batch fills the data axes, else over "data" (long
context, B = 1): prefill hands each layer's heads over to the sequence
parts by an all-to-all, and decode runs D1's split mode on its part and
merges over that axis (``models.layers.split_decode_attention``); the
logits are the rank's rows and vocabulary slice, the greedy token a
vocab-parallel argmax (``collectives.vocab_argmax``).

An attn+moe layer of the serving steps runs the reference's pjit MoE
under its hints (``MOE_SPEC``, ``MOE_COMBINE_SPEC``, ``MOE_GROUPS``):
``models.moe.apply_moe`` on the rank's E / tp experts, their FSDP
shards gathered at the layer, and its rows; the decode cache's ``moe``
occupancy is replicated, each rank routing its rows of it and
all-gathering their new counts (``model.apply_block``, by the rows'
entry of the ``act`` hint).

A mesh refuses, naming the factory and the ROADMAP item that will lift
the refusal: rwkv and mamba layers (Queue 1 item 4b.4), frontend
embeddings (4b.5), the shared attention block (4b.6), tied embeddings
(4b.7) and, in training, the pjit MoE (4b.8b: the train step takes the
shard_map MoE).
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import as_tensor, tree
from repro_torch.core.precision import policy as precision_policy
from repro_torch.interop import F32_LEAVES
from repro_torch.launch.mesh import axes_group
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     global_norm)
from repro_torch.parallel import collectives as C
from repro_torch.parallel import context
from repro_torch.parallel import sharding as S
from repro_torch.parallel.sharding import TP, P

# the layer kinds a mesh takes
MESH_KINDS = ("attn", "attn_local", "attn_global", "attn+moe")


def default_optimizer(total_steps: int = 10000,
                      master_weights: bool = False) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, 200, total_steps),
                 master_weights=master_weights)


def cast_params_bf16(params):
    """Model params in bf16 (f32 leaves of two or more dims); norm scales
    and bias vectors stay f32."""
    return tree.map(lambda x: x.to(torch.bfloat16)
                    if x.dim() >= 2 and x.dtype == torch.float32 else x,
                    params)


def _dp_axis(mesh):
    """The FSDP axes ``mesh`` has, as a spec entry: a name, or a tuple."""
    return S._filter(P(S.FSDP), mesh)[0]


def abstract_params(cfg: ArchConfig):
    """The params' tree on the ``meta`` device: every leaf's shape, in f32
    as the reference's ``init_params`` makes them."""
    return M.init_params(cfg, device="meta", param_dtype=torch.float32)


def abstract_opt_state(cfg: ArchConfig, optimizer: AdamW) -> AdamWState:
    """``optimizer.init`` of :func:`abstract_params`, on ``meta``."""
    return optimizer.init(abstract_params(cfg))


def abstract_cache(cfg: ArchConfig, shape: ShapeSpec):
    """The decode cache of ``shape``'s global batch and sequence on the
    ``meta`` device: every leaf's shape and dtype as the reference's
    ``jax.eval_shape`` of ``init_cache``, no memory."""
    return M.init_cache(cfg, shape.global_batch, shape.seq_len,
                        device="meta")


def value_and_grad(loss_of: Callable, params) -> Tuple[torch.Tensor, object]:
    """(loss, the gradient tree of ``loss_of(params)``), as
    ``jax.value_and_grad``: each leaf's gradient in its own dtype, zeros
    where the loss does not reach it."""
    leaves = tree.leaves(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_of(tree.unflatten(params, req))
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def inputs_on(params, tokens, embeddings=None):
    """``tokens`` and ``embeddings`` (numpy or tensors) on the params'
    device."""
    dev = tree.leaves(params)[0].device
    tokens = as_tensor(tokens, dev)
    return tokens, None if embeddings is None else as_tensor(embeddings, dev)


def _accumulate(loss_of: Callable, params, tokens, embeddings, k: int):
    """(loss, grads) of ``loss_of(tokens, embeddings)(params)``; over ``k``
    microbatches of the rows, their f32 gradients summed and divided by
    ``k``, the losses averaged (the reference's scan)."""
    if k == 1:
        return value_and_grad(loss_of(tokens, embeddings), params)
    B = tokens.shape[0]
    if B % k:
        raise ValueError(f"train_step: batch {B} does not split into {k} "
                         "microbatches")
    mb = B // k
    loss = torch.zeros((), device=tokens.device)
    grads = tree.map(lambda p: torch.zeros(p.shape, device=p.device), params)
    for i in range(k):
        rows = slice(i * mb, (i + 1) * mb)
        l, g = value_and_grad(loss_of(
            tokens[rows], None if embeddings is None else embeddings[rows]),
            params)
        tree.map(lambda acc, gi: acc.add_(gi), grads, g)
        loss = loss + l
    return loss / k, tree.map(lambda g: g / k, grads)


def make_train_step(cfg: ArchConfig, shape: ShapeSpec,
                    optimizer: Optional[AdamW] = None, *,
                    seq_chunk: int = 512, impl: str = "chunked",
                    microbatches: Optional[int] = None,
                    attn_impl: Optional[str] = None, mesh=None,
                    seq_parallel: bool = True, moe_impl: str = "pjit",
                    moe_dispatch: Optional[str] = None):
    """The train step of ``cfg`` at ``shape`` (its ``microbatches`` unless
    given) on the params' device; ``attn_impl`` (default ``impl``) is the
    attention's ("chunked", or "kernel_sharded": K3 forward, chunked
    backward).  With ``mesh``: the reference's triple, the step over the
    mesh's ranks (module docstring; ``seq_parallel``, ``moe_impl`` and
    ``moe_dispatch`` are the reference's keywords and apply there)."""
    optimizer = optimizer or default_optimizer()
    k = microbatches or shape.microbatches
    impl = attn_impl or impl
    if mesh is not None:
        return _mesh_train_step(cfg, optimizer, mesh, k=k, impl=impl,
                                seq_chunk=seq_chunk,
                                seq_parallel=seq_parallel,
                                moe_impl=moe_impl, moe_dispatch=moe_dispatch)

    def loss_of(tokens, embeddings):
        return lambda p: M.loss_fn(p, tokens, cfg, embeddings=embeddings,
                                   impl=impl, seq_chunk=seq_chunk)

    def train_step(params, opt_state, tokens, embeddings=None):
        tokens, embeddings = inputs_on(params, tokens, embeddings)
        loss, grads = _accumulate(loss_of, params, tokens, embeddings, k)
        gn = global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gn}

    return train_step


# ------------------------------------------------------------ on a mesh ---

def _refuse(cfg: ArchConfig, who: str, moe_impl: Optional[str]) -> None:
    """Raise, naming the factory ``who`` and the ROADMAP item, for what a
    mesh does not take; ``moe_impl`` the train step's (None: the serving
    steps, which take either MoE impl)."""
    bad = sorted(set(cfg.block_unit) - set(MESH_KINDS))
    takes = ("attn+moe under moe_impl='shard_map'" if moe_impl is not None
             else "attn+moe")
    train_pjit = moe_impl is not None and moe_impl != "shard_map"
    for hit, why, item in (
            (bad, f"{bad} layers", "4b.4"),
            (cfg.frontend != "none", f"frontend {cfg.frontend!r} embeddings",
             "4b.5"),
            (cfg.shared_attn_every, "the shared attention block", "4b.6"),
            (cfg.tie_embeddings, "tied embeddings", "4b.7"),
            (cfg.n_experts and train_pjit,
             f"moe_impl={moe_impl!r} (the pjit MoE) in training", "4b.8b")):
        if hit:
            raise ValueError(
                f"{who}: {cfg.name}'s {why} under a mesh are not ported "
                f"(ROADMAP Queue 1 item {item}); a mesh takes attn, "
                f"attn_local / attn_global and {takes}")


def _check_widths(cfg: ArchConfig, n_dp: int, n_tp: int,
                  who: str = "make_train_step(mesh=)") -> None:
    """Raise, naming the factory ``who`` and the sizes, where a width does
    not split."""
    splits = [("n_heads", cfg.n_heads, n_tp, TP),
              ("n_kv_heads", cfg.n_kv_heads, n_tp, TP),
              ("d_ff", cfg.d_ff, n_tp, TP),
              ("padded_vocab", cfg.padded_vocab, n_tp, TP),
              ("d_model", cfg.d_model, n_dp, "FSDP axes")]
    if cfg.n_experts:
        splits.append(("n_experts", cfg.n_experts, n_tp, TP))
    for what, size, n, axes in splits:
        if size % n:
            raise ValueError(f"{who}: {cfg.name}'s {what} {size} does not "
                             f"divide over the {n} ranks of {axes!r}")


def gather_params(local, specs, mesh, compute_dtype, experts: bool = False):
    """The tree the model runs on under a mesh, from this rank's ``local``
    params (``specs``: their ``param_specs``), inside the step's hints:
    each leaf gathered over its FSDP axes (``collectives.Gather``:
    backward, the gradient reduce-scattered back to the shard), the
    matmul weights cast to ``compute_dtype`` first; a leaf replicated over
    the FSDP axes is kept, its gradient summed over them.  A leaf
    replicated over "model" also has its gradient summed over "model"
    where the ranks there use it for different work: under sequence
    parallelism every one (they hold different positions); without, the
    attention's ``q_norm`` / ``k_norm`` (they act on the rank's own
    heads), while the other norms then act on the replicated stream and
    each rank's gradient is already whole.  The MoE layer's own leaves go
    to ``moe_block`` as it takes them, which reduces their gradients over
    both axes: the experts as they are, the router gathered whole
    (backward: this rank's own part).  With ``experts`` (the pjit MoE of
    the serving steps) the experts too are gathered over their FSDP axes,
    each rank's E / tp of them, cast to ``compute_dtype``."""
    dp = C.Axis(*axes_group(mesh, _dp_axis(mesh)))
    tp = C.Axis(*axes_group(mesh, TP))
    seq_parallel = C.seq_parallel()

    def leaf(path, spec, t):
        if "experts" in path and not experts:
            return t
        split = [d for d, e in enumerate(spec) if e is not None and e != TP]
        if path[-1] == "router":
            return C.Assemble.apply(t, split[0], dp.group, dp.n, dp.index)
        cast = None if path[-1] in F32_LEAVES else compute_dtype
        groups = []
        if split:
            t = C.Gather.apply(t, split[0], dp.group, dp.n, cast)
        else:
            groups.append(dp.group)
        if TP not in spec and (seq_parallel or
                               path[-2:-1] in (("q_norm",), ("k_norm",))):
            groups.append(tp.group)
        if groups:
            t = C.Replicated.apply(t, tuple(groups))
        return t if split or cast is None else t.to(cast)

    return S.map_specs(leaf, specs, local)


def layer_gather(specs, mesh, compute_dtype,
                 experts: bool = False) -> Callable:
    """``model.hidden_forward``'s ``layer_params`` under a mesh:
    :func:`gather_params` of one layer's slice of ``params["blocks"]``
    (``specs``: the whole tree's ``param_specs``, whose stacked leaves
    lead with the unsplit repeat axis).  The model calls it inside the
    superblock's remat, so a layer's weights are gathered in its forward
    and again in its recompute, and its gradients reduce-scattered in its
    backward: one superblock's gathered weights and full-size gradients
    are live at a time, not the model's.  ``experts`` as
    :func:`gather_params`'s."""
    slots = [S.map_specs(lambda _, s: P(*s[1:]), slot)
             for slot in specs["blocks"]]
    return lambda j, p: gather_params(p, slots[j], mesh, compute_dtype,
                                      experts)


def sharded_norm(grads, specs, mesh) -> torch.Tensor:
    """The global norm of the gradient tree whose shards the ranks hold
    (``grads`` this rank's, ``specs`` their layout): each rank sums the
    squares of the parts it holds, a part replicated over some axes
    counted by the rank at coordinate 0 on them only, then the sums are
    all-reduced over the mesh.  The same f32 () tensor on every rank."""
    coords = S.my_coords(mesh)

    def leaf(path, spec, g):
        held = {a for e in spec for a in S.entry_axes(e)}
        if all(coords[a] == 0 for a in coords if a not in held):
            return torch.sum(torch.square(g.float()))
        return None

    zero = torch.zeros((), device=tree.leaves(grads)[0].device)
    total = sum(tree.leaves(S.map_specs(leaf, specs, grads)), zero)
    return torch.sqrt(C.all_reduce(total, dist.group.WORLD))


def _mesh_train_step(cfg: ArchConfig, optimizer: AdamW, mesh, *, k: int,
                     impl: str, seq_chunk: int, seq_parallel: bool,
                     moe_impl: str, moe_dispatch: Optional[str]):
    """:func:`make_train_step` with a mesh (module docstring)."""
    _refuse(cfg, "make_train_step(mesh=)", moe_impl)
    n_dp = S.data_axis_size(mesh)
    n_tp = S.axis_sizes(mesh).get(TP, 1)
    _check_widths(cfg, n_dp, n_tp)
    dp = _dp_axis(mesh)
    hints = dict(
        act=P(dp, TP, None) if seq_parallel else P(dp, None, None),
        moe=P(TP, dp, None, None) if cfg.n_experts else None,
        logit=P(dp, None, TP),
        moe_groups=n_dp if cfg.n_experts else None,
        moe_combine=P(dp, None, None) if cfg.n_experts else None,
        moe_impl=moe_impl, moe_dispatch=moe_dispatch, mesh=mesh)
    p_specs = S.param_specs(abstract_params(cfg), mesh)
    o_specs = AdamWState(m=p_specs, v=p_specs, count=P(),
                         master=(p_specs if optimizer.master_weights
                                 else None))
    tok_spec, emb_spec = P(dp, None), P(dp, None, None)
    cd = precision_policy(cfg.policy).compute_dtype

    top_specs = {name: s for name, s in p_specs.items() if name != "blocks"}
    per_layer = layer_gather(p_specs, mesh, cd)

    def loss_of(tokens, _):
        def loss(local):
            # embed, unembed and the final norm here; a layer's inside its
            # superblock's remat
            params = gather_params({name: local[name] for name in top_specs},
                                   top_specs, mesh, cd)
            return M.loss_fn({**params, "blocks": local["blocks"]}, tokens,
                             cfg, impl=impl, seq_chunk=seq_chunk,
                             layer_params=per_layer)
        return loss

    def train_step(params, opt_state, tokens, embeddings=None):
        if embeddings is not None:
            raise ValueError("make_train_step(mesh=): frontend embeddings "
                             "under a mesh are not ported (ROADMAP Queue 1 "
                             "item 4b.5)")
        tokens, _ = inputs_on(params, tokens)
        B, S_len = tokens.shape
        if B % (n_dp * k):
            raise ValueError(f"train_step: the batch {B} does not divide "
                             f"over the {n_dp} ranks of {dp!r}"
                             + (f" times {k} microbatches" if k > 1 else ""))
        if S_len % n_tp:
            raise ValueError(f"train_step: the sequence {S_len} does not "
                             f"divide over the {n_tp} ranks of {TP!r}")
        tokens = tokens[S.local_index(tok_spec, tokens.shape, mesh,
                                      S.my_coords(mesh), "tokens")]
        with context.activation_specs(**hints):
            # the backward inside too: remat reruns the forward there
            loss, grads = _accumulate(loss_of, params, tokens, None, k)
        loss = C.all_reduce(loss, axes_group(mesh, dp)[0])
        gn = sharded_norm(grads, p_specs, mesh)
        new_params, new_opt = optimizer.update(grads, opt_state, params,
                                               norm=gn)
        return new_params, new_opt, {"loss": loss, "grad_norm": gn}

    return train_step, (p_specs, o_specs, tok_spec, emb_spec), \
        (p_specs, o_specs, {"loss": P(), "grad_norm": P()})


# ------------------------------------------------------------- serving ---

def _serving_mesh(cfg: ArchConfig, mesh, who: str, moe_impl: str = "pjit"):
    """The checks the serving factories share; returns (the params'
    specs, the dp entry, its ranks, the "model" ranks, ``model_params``:
    a rank's params -> the tree the model runs on, the unstacked leaves
    gathered (:func:`gather_params`) and each stacked layer's at the layer
    (:func:`layer_gather`, passed as ``layer_params``; the experts
    gathered over their FSDP axes for the pjit MoE, kept as the shards
    ``moe_block`` takes for ``moe_impl="shard_map"``), the MoE hints)."""
    _refuse(cfg, who, None)
    n_dp = S.data_axis_size(mesh)
    n_tp = S.axis_sizes(mesh).get(TP, 1)
    _check_widths(cfg, n_dp, n_tp, who)
    p_specs = S.param_specs(abstract_params(cfg), mesh)
    cd = precision_policy(cfg.policy).compute_dtype
    top = {name: s for name, s in p_specs.items() if name != "blocks"}

    def model_params(local):
        whole = gather_params({k: local[k] for k in top}, top, mesh, cd)
        return {**whole, "blocks": local["blocks"]}

    dp = _dp_axis(mesh)
    moe_hints = dict(moe=P(TP, dp, None, None), moe_combine=P(dp, None, None),
                     moe_groups=n_dp) if cfg.n_experts else {}
    return p_specs, dp, n_dp, n_tp, model_params, \
        layer_gather(p_specs, mesh, cd, experts=moe_impl != "shard_map"), \
        moe_hints


def _cache_layout(cfg: ArchConfig, shape: ShapeSpec, mesh, who: str):
    """(the abstract cache, its ``cache_specs``, the mesh axis its K / V
    sequence is split over, read from the specs: "model", "data" or None).
    Raises, naming ``who`` and the sizes, where a K / V leaf's sequence
    (``max_seq``, or a ring's window) does not divide over that axis."""
    cache = abstract_cache(cfg, shape)
    c_specs = S.cache_specs(cache, cfg, mesh, batch=shape.global_batch)
    axes = set()
    zero = {a: 0 for a in mesh.mesh_dim_names}

    def leaf(path, spec, t):
        if path[-1] in ("k", "v"):
            axes.add(spec[3])
            try:
                S.local_index(spec, t.shape, mesh, zero, "/".join(path))
            except ValueError as e:
                raise ValueError(f"{who}: the decode cache's {e}") from None

    S.map_specs(leaf, c_specs, cache)
    (axis,) = axes
    return cache, c_specs, axis


def _check_parts(parts, whole, specs, mesh) -> None:
    """Raise, naming the leaf, where this rank's ``parts`` are not the
    shapes of its parts of the global tree ``whole`` under ``specs``."""
    coords = S.my_coords(mesh)

    def leaf(path, spec, t, part):
        name = "/".join(path)
        idx = S.local_index(spec, t.shape, mesh, coords, name)
        want = tuple(len(range(*i.indices(n))) for i, n in zip(idx, t.shape))
        if tuple(part.shape) != want:
            raise ValueError(f"serve_step: cache leaf {name} is "
                             f"{tuple(part.shape)} on this rank; its part "
                             f"of {tuple(t.shape)} is {want}")

    S.map_specs(leaf, specs, whole, parts)


def _local_rows(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's rows of a global (B, ...) tensor under ``spec``'s batch
    entry."""
    idx = S.local_index(P(spec[0]), t.shape[:1], mesh, S.my_coords(mesh),
                        "the batch")
    return t[idx]


def make_prefill_step(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
                      impl: str = "chunked", seq_parallel: bool = True,
                      moe_impl: str = "pjit",
                      moe_dispatch: Optional[str] = None):
    """The reference's triple ``(prefill_step, (p_specs, P(dp, None), P(dp,
    None, None)), (P(dp, None, "model"), c_specs, P()))``.
    ``prefill_step(params, tokens, embeddings=None)`` takes this rank's
    part of the params and the global (B, S) tokens, cuts its rows, and
    runs ``model.prefill`` at ``max_seq = shape.seq_len`` inside the
    reference's hints (the stream's sequence over "model" with
    ``seq_parallel``), each layer's FSDP shards gathered at the layer;
    ``impl`` "chunked", "kernel" or "kernel_sharded" (K3 on the rank's
    heads over the whole sequence).  Returns (its logits part (B_loc, 1,
    V/tp): its rows and vocabulary slice, its cache part under
    ``c_specs``: every head over its block of the sequence, ``S_total`` a
    () int32 tensor).  A batch that does not divide over the data axes, a
    sequence that does not divide over "model" under ``seq_parallel`` and
    embeddings raise, naming the sizes or the ROADMAP item.
    ``moe_impl`` / ``moe_dispatch`` are the reference's keywords: an
    attn+moe layer runs the pjit MoE on the rank's experts and rows
    (``models.moe.apply_moe`` under the MoE hints), the routing occupancy
    gathered whole on every rank; ``moe_impl="shard_map"`` warns as the
    reference does and runs the expert-parallel layer, whose counts are
    zeros."""
    who = "make_prefill_step"
    if cfg.n_experts and moe_impl == "shard_map":
        warnings.warn(
            "make_prefill_step(moe_impl='shard_map'): the shard_map MoE impl "
            "is train-only and cannot fill the decode cache's routing "
            "occupancy, so a subsequent decode would see a different MoE "
            "drop set than this prefill. Serve with the pjit impl.",
            RuntimeWarning, stacklevel=2)
    p_specs, dp, n_dp, n_tp, model_params, per_layer, moe_hints = \
        _serving_mesh(cfg, mesh, who, moe_impl)
    if impl not in ("chunked", "kernel", "kernel_sharded"):
        raise ValueError(f"{who}: impl {impl!r}; the mesh takes 'chunked', "
                         "'kernel' and 'kernel_sharded'")
    _, c_specs, axis = _cache_layout(cfg, shape, mesh, who)
    hints = dict(act=P(dp, TP, None) if seq_parallel else P(dp, None, None),
                 moe_impl=moe_impl, moe_dispatch=moe_dispatch, mesh=mesh,
                 **moe_hints)
    tok_spec = P(dp, None)

    def prefill_step(params, tokens, embeddings=None):
        if embeddings is not None:
            raise ValueError(f"{who}: frontend embeddings under a mesh are "
                             "not ported (ROADMAP Queue 1 item 4b.5)")
        tokens, _ = inputs_on(params, tokens)
        B, S_len = tokens.shape
        if B % n_dp:
            raise ValueError(f"prefill_step: the batch {B} does not divide "
                             f"over the {n_dp} ranks of {dp!r}")
        if seq_parallel and S_len % n_tp:
            raise ValueError(f"prefill_step: the sequence {S_len} does not "
                             f"divide over the {n_tp} ranks of {TP!r}")
        tokens = _local_rows(tokens, tok_spec, mesh)
        with torch.no_grad(), context.activation_specs(**hints):
            logits, cache, S_total = M.prefill(
                model_params(params), tokens, cfg, max_seq=shape.seq_len,
                impl=impl, layer_params=per_layer, cache_axis=axis)
        return logits, cache, torch.tensor(S_total, dtype=torch.int32,
                                           device=tokens.device)

    return prefill_step, (p_specs, tok_spec, P(dp, None, None)), \
        (P(dp, None, TP), c_specs, P())


def make_serve_step(cfg: ArchConfig, shape: ShapeSpec, mesh, *,
                    greedy: bool = True,
                    moe_dispatch: Optional[str] = None):
    """One-token decode and greedy sampling over the mesh's ranks: the
    reference's triple ``(serve_step, (p_specs, c_specs, P(), tok_spec),
    (tok_spec, None, c_specs))``, ``tok_spec`` ``P(dp, None)`` when
    ``shape.global_batch`` fills the data axes, else ``P(None, None)``
    (the reference's ``batch_ok``; the cache's sequence is then split
    over "data" instead of "model").
    ``serve_step(params, cache, pos, tokens_1)`` takes this rank's part
    of the params and of the cache (``c_specs``), the global (B, 1) tokens
    and the write position: the reference's () int (an int or a ()
    tensor) or a (B,) vector (numpy or a tensor, the global rows), an int
    or numpy position checked against the cache's capacity first.  It
    decodes on the rank's rows (all of them under ``P(None, None)``),
    updates the cache part in place and returns (the greedy token (B_loc,
    1) int32, the same on every rank of "model": the vocab-parallel argmax
    over the ids below ``cfg.vocab_size``, ties to the lowest id; the
    logits (B_loc, 1, V/tp) f32, the rank's rows and vocabulary slice,
    where the reference's triple has ``None``; the cache part).
    ``greedy`` and ``moe_dispatch`` are the reference's keywords.  An
    attn+moe layer runs the pjit MoE on the rank's experts and rows, each
    row routed from its own counts; the ``moe`` leaf is replicated
    (``c_specs``), its rows' new counts all-gathered into every rank's
    copy."""
    who = "make_serve_step"
    p_specs, dp, n_dp, _, model_params, per_layer, moe_hints = \
        _serving_mesh(cfg, mesh, who)
    whole_cache, c_specs, axis = _cache_layout(cfg, shape, mesh, who)
    batch_ok = shape.global_batch % n_dp == 0 and \
        shape.global_batch >= n_dp
    tok_spec = P(dp, None) if batch_ok else P(None, None)
    hints = dict(act=P(tok_spec[0], None, None), moe_dispatch=moe_dispatch,
                 mesh=mesh, **moe_hints)
    cap = M.cache_capacity(whole_cache, cfg)

    def serve_step(params, cache, pos, tokens_1):
        _check_parts(cache, whole_cache, c_specs, mesh)
        tokens_1, _ = inputs_on(params, tokens_1)
        B = tokens_1.shape[0]
        if B != shape.global_batch:
            raise ValueError(f"serve_step: {B} rows of tokens; the cache "
                             f"holds {shape.global_batch}")
        if isinstance(pos, torch.Tensor):
            pos = pos.to(tokens_1.device).reshape(-1).long().expand(B)
        else:
            host = np.broadcast_to(np.asarray(pos, np.int64).reshape(-1),
                                   (B,))
            if cap is not None and int(host.max()) >= cap:
                raise ValueError(
                    f"serve_step: KV-cache overflow -- write position "
                    f"{int(host.max())} >= cache capacity {cap} (max_seq)")
            pos = torch.tensor(host, device=tokens_1.device)
        mine = lambda t: _local_rows(t, tok_spec, mesh)  # noqa: E731
        with torch.no_grad(), context.activation_specs(**hints):
            logits, cache = M.decode_step(
                model_params(params), cfg, cache, mine(pos).contiguous(),
                mine(tokens_1), layer_params=per_layer, cache_axis=axis)
            nxt = C.vocab_argmax(logits[:, -1], cfg.vocab_size)
        return nxt.to(torch.int32)[:, None], logits, cache

    return serve_step, (p_specs, c_specs, P(), tok_spec), \
        (tok_spec, None, c_specs)
