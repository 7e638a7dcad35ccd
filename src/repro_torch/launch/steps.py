"""Step factories of training (``repro/launch/steps.py``): on one device,
and over the ranks of a mesh.

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
(``moe_impl="shard_map"``).  A mesh refuses, naming the ROADMAP item that
will lift the refusal: rwkv and mamba layers (Queue 1 item 4b.4),
frontend embeddings (4b.5), the shared attention block (4b.6), tied
embeddings (4b.7) and the pjit MoE (4b.8).  ``make_prefill_step``,
``make_serve_step`` and ``abstract_cache`` are item 4b.2b.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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

def _refuse(cfg: ArchConfig, moe_impl: str) -> None:
    """Raise, naming the ROADMAP item, for what a mesh does not take."""
    bad = sorted(set(cfg.block_unit) - set(MESH_KINDS))
    for hit, why, item in (
            (bad, f"{bad} layers", "4b.4"),
            (cfg.frontend != "none", f"frontend {cfg.frontend!r} embeddings",
             "4b.5"),
            (cfg.shared_attn_every, "the shared attention block", "4b.6"),
            (cfg.tie_embeddings, "tied embeddings", "4b.7"),
            (cfg.n_experts and moe_impl != "shard_map",
             f"moe_impl={moe_impl!r} (the pjit MoE)", "4b.8")):
        if hit:
            raise ValueError(
                f"make_train_step(mesh=): {cfg.name}'s {why} under a mesh "
                f"are not ported (ROADMAP Queue 1 item {item}); a mesh takes "
                "attn, attn_local / attn_global and attn+moe under "
                "moe_impl='shard_map'")


def _check_widths(cfg: ArchConfig, n_dp: int, n_tp: int) -> None:
    """Raise, naming the sizes, where a width does not split."""
    splits = [("n_heads", cfg.n_heads, n_tp, TP),
              ("n_kv_heads", cfg.n_kv_heads, n_tp, TP),
              ("d_ff", cfg.d_ff, n_tp, TP),
              ("padded_vocab", cfg.padded_vocab, n_tp, TP),
              ("d_model", cfg.d_model, n_dp, "FSDP axes")]
    if cfg.n_experts:
        splits.append(("n_experts", cfg.n_experts, n_tp, TP))
    for what, size, n, axes in splits:
        if size % n:
            raise ValueError(f"make_train_step(mesh=): {cfg.name}'s {what} "
                             f"{size} does not divide over the {n} ranks of "
                             f"{axes!r}")


def gather_params(local, specs, mesh, compute_dtype):
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
    (backward: this rank's own part)."""
    dp = C.Axis(*axes_group(mesh, _dp_axis(mesh)))
    tp = C.Axis(*axes_group(mesh, TP))
    seq_parallel = C.seq_parallel()

    def leaf(path, spec, t):
        if "experts" in path:
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


def layer_gather(specs, mesh, compute_dtype) -> Callable:
    """``model.hidden_forward``'s ``layer_params`` under a mesh:
    :func:`gather_params` of one layer's slice of ``params["blocks"]``
    (``specs``: the whole tree's ``param_specs``, whose stacked leaves
    lead with the unsplit repeat axis).  The model calls it inside the
    superblock's remat, so a layer's weights are gathered in its forward
    and again in its recompute, and its gradients reduce-scattered in its
    backward: one superblock's gathered weights and full-size gradients
    are live at a time, not the model's."""
    slots = [S.map_specs(lambda _, s: P(*s[1:]), slot)
             for slot in specs["blocks"]]
    return lambda j, p: gather_params(p, slots[j], mesh, compute_dtype)


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
    _refuse(cfg, moe_impl)
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
