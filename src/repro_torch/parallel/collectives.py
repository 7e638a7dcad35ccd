"""Collectives over ``torch.distributed`` groups, and the autograd functions
that carry each with the transpose JAX gives it.

The plain collectives (:func:`all_to_all`, :func:`all_gather`,
:func:`reduce_scatter`, :func:`all_reduce`, :func:`all_reduce_max`) take
the group's tensors as they are: gloo takes CPU tensors and, on the card,
CUDA tensors.  They use the list forms of gloo's collectives.  The
autograd functions call them by this module's name, forward and backward,
so a caller that wraps them (``chip_smoke.py`` times each) sees every call.

The functions, each forward / backward:

* :class:`AllToAll`: ``all_to_all`` / the same (the inverse layout change
  is in the caller's reshapes);
* :class:`Gather`: all-gather / reduce-scatter (sum).  A weight's FSDP
  shards (``dtype=`` casts them first and sends the gradient back in the
  shard's own dtype), and under sequence parallelism the residual
  stream's blocks before a column-parallel product;
* :class:`ReduceScatter`: reduce-scatter / all-gather.  A row-parallel
  product's partial sums under sequence parallelism;
* :class:`Replicated`: identity / all-reduce over each group.  A tensor
  replicated over the group that each rank uses for different work (a
  weight's gradient summed over the ranks), and, without sequence
  parallelism, the stream before a column-parallel product;
* :class:`AllReduce`: all-reduce / identity.  A row-parallel product's
  partial sums without sequence parallelism, and the vocab-parallel
  softmax's sums;
* :class:`Assemble`: all-gather of the ranks' blocks / this rank's own
  block of the cotangent, never a sum;
* :class:`Split`: this rank's own block of a replicated tensor /
  all-gather of the blocks' cotangents.

With these, each rank runs the backward of its own part of the loss, and
every rank ends with the whole gradient of the parts it holds.

The tensor-parallel helpers at the end read ``parallel.context``: under
``ACT_SPEC`` (set by ``launch.steps.make_train_step(mesh=)`` and the
serving steps ``make_prefill_step`` / ``make_serve_step``) the model runs
on the rank's local tensors, "model" splitting heads, ``d_ff`` and the
vocabulary, and, when ``ACT_SPEC``'s sequence entry is "model", the
residual stream's sequence between blocks.  The serving steps also take
the prompt's last position from the rank that holds it
(:func:`last_position`) and the greedy token from the vocabulary's slices
(:func:`vocab_argmax`), and the MoE layer its rows of the routing
occupancy (:func:`own_rows`, :func:`all_rows`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axes_group
from repro_torch.parallel import context
from repro_torch.parallel.sharding import TP

# the plain collectives, by name (what a wrapper replaces to watch them)
PLAIN = ("all_to_all", "all_gather", "reduce_scatter", "all_reduce",
         "all_reduce_max")


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` over ``group``: dim 0 in equal parts, part k
    to rank k, the parts received concatenated on dim 0 in rank order."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def all_gather(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` concatenated on ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def reduce_scatter(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Part ``rank`` of ``t`` along ``dim``, summed over the ``n`` ranks."""
    parts = [c.contiguous() for c in t.chunk(n, dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks."""
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise largest ``t`` over ``group``'s ranks (no
    gradient)."""
    out = t.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; its transpose is itself."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class Gather(torch.autograd.Function):
    """:func:`all_gather` of the ranks' parts (cast to ``dtype`` first when
    one is given); backward: the gradient reduce-scattered (summed) back to
    the parts, in the part's own dtype (so a bf16 use of an f32 shard sums
    its gradient in f32)."""

    @staticmethod
    def forward(ctx, t, dim, group, n, dtype=None):
        ctx.args = (dim, group, n)
        ctx.dtype = t.dtype
        return all_gather(t if dtype is None else t.to(dtype), dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter(g.to(ctx.dtype), *ctx.args), None, None, None,
                None)


class ReduceScatter(torch.autograd.Function):
    """:func:`reduce_scatter`; backward: the cotangent's parts
    all-gathered."""

    @staticmethod
    def forward(ctx, t, dim, group, n):
        ctx.args = (dim, group, n)
        return reduce_scatter(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


class Replicated(torch.autograd.Function):
    """Identity on a tensor replicated over ``groups``; backward: its
    gradient summed over each group in turn."""

    @staticmethod
    def forward(ctx, t, groups):
        ctx.groups = groups
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = all_reduce(g, group)
        return g, None


class AllReduce(torch.autograd.Function):
    """:func:`all_reduce` (sum); backward: identity (every rank computes
    the same thing from the sum, and its own part's gradient is that
    sum's)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Assemble(torch.autograd.Function):
    """:func:`all_gather` of the ranks' output blocks; backward: this
    rank's own block of the cotangent (coordinate ``i``)."""

    @staticmethod
    def forward(ctx, t, dim, group, n, i):
        ctx.part = (dim, i, t.shape[dim])
        return all_gather(t, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, i, w = ctx.part
        return g.narrow(dim, i * w, w), None, None, None, None


class Split(torch.autograd.Function):
    """Block ``i`` of ``n`` along ``dim`` of a tensor replicated over
    ``group``; backward: the blocks' cotangents all-gathered, so every
    rank has the whole gradient of the replicated tensor."""

    @staticmethod
    def forward(ctx, t, dim, group, n, i):
        ctx.args = (dim, group, n)
        w = t.shape[dim] // n
        return t.narrow(dim, i * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None


# ------------------------------------------------- tensor parallelism ------

class Axis(NamedTuple):
    """A mesh axis (or the FSDP axes merged) as the collectives need it."""
    group: object
    n: int
    index: int


def axis(names) -> Axis:
    """``context.MESH``'s axis ``names`` (one name, or a tuple merged
    row-major): ``launch.mesh.axes_group``."""
    return Axis(*axes_group(context.MESH, names))


def active() -> bool:
    """Whether the model runs on this rank's local tensors
    (``context.ACT_SPEC`` set)."""
    return context.ACT_SPEC is not None


def seq_parallel() -> bool:
    """Whether the residual stream's sequence is split over "model"
    between blocks (``ACT_SPEC``'s sequence entry)."""
    return context.ACT_SPEC is not None and context.ACT_SPEC[1] == TP


def enter(x: torch.Tensor) -> torch.Tensor:
    """The residual stream (B_loc, S_loc, d) before a column-parallel
    product: under sequence parallelism its blocks gathered over "model"
    (backward: reduce-scatter), else the replicated stream as it is
    (backward: the ranks' gradients summed)."""
    tp = axis(TP)
    if seq_parallel():
        return Gather.apply(x, 1, tp.group, tp.n)
    return Replicated.apply(x, (tp.group,))


def leave(y: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums (B_loc, S, d) back to the
    stream: reduce-scattered over "model" to this rank's sequence block
    under sequence parallelism, else all-reduced."""
    tp = axis(TP)
    if seq_parallel():
        return ReduceScatter.apply(y, 1, tp.group, tp.n)
    return AllReduce.apply(y, tp.group)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The vocab-parallel lookup: ``table`` is this rank's (V/tp, d) rows
    of the embedding; each token's row from the rank that owns it (zeros
    from the others), summed over "model" into the stream's layout
    (:func:`leave`).  A sum of one row and zeros: exact."""
    tp = axis(TP)
    rows = table.shape[0]
    local = tokens.long() - tp.index * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return leave(x)


def vocab_cross_entropy(logits: torch.Tensor, tgt: torch.Tensor,
                        vocab_size: int, neg_inf: float) -> torch.Tensor:
    """-log softmax(logits)[tgt] over the whole vocabulary from this
    rank's (..., V/tp) f32 slice of it: ids at or past ``vocab_size``
    (global, this rank's offset tp index x V/tp) masked with ``neg_inf``,
    the max and the sum of ``exp`` taken over "model", the target's logit
    from the rank that owns it.  Every rank of "model" returns the same
    values; each one's backward reaches its own slice."""
    tp = axis(TP)
    width = logits.shape[-1]
    lo = tp.index * width
    ids = lo + torch.arange(width, device=logits.device)
    logits = torch.where(ids >= vocab_size, neg_inf, logits)
    m = all_reduce_max(logits.amax(dim=-1), tp.group)
    z = logits - m[..., None]
    lse = torch.log(AllReduce.apply(torch.exp(z).sum(dim=-1), tp.group))
    local = tgt.long() - lo
    mine = (local >= 0) & (local < width)
    picked = torch.gather(z, -1, local.clamp(0, width - 1)[..., None])[..., 0]
    picked = AllReduce.apply(torch.where(mine, picked,
                                         torch.zeros_like(picked)), tp.group)
    return lse - picked


def last_position(x: torch.Tensor) -> torch.Tensor:
    """The stream's last position (B_loc, 1, d) on every rank: under
    sequence parallelism the last "model" rank's, gathered (the ranks
    hold consecutive blocks of the sequence), else ``x[:, -1:]``."""
    if not seq_parallel():
        return x[:, -1:]
    tp = axis(TP)
    return all_gather(x[:, -1:], 1, tp.group, tp.n)[:, -1:]


def own_rows(t: torch.Tensor, entry) -> torch.Tensor:
    """This rank's rows of a global (B, ...) tensor whose batch the spec
    entry ``entry`` splits (a view; ``None``: every row)."""
    if entry is None:
        return t
    ax = axis(entry)
    w = t.shape[0] // ax.n
    return t[ax.index * w:(ax.index + 1) * w]


def all_rows(t: torch.Tensor, entry) -> torch.Tensor:
    """The global (B, ...) tensor from every rank's rows under ``entry``
    (gathered in rank order; ``None``: ``t`` itself, every rank holds
    every row)."""
    if entry is None:
        return t
    ax = axis(entry)
    return all_gather(t, 0, ax.group, ax.n)


def vocab_argmax(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """The greedy token from this rank's (..., V/tp) slice of the logits:
    each rank takes the largest value of its slice and its first index,
    ids at or past ``vocab_size`` (global, this rank's offset tp index x
    V/tp) excluded; the candidates are all-gathered over "model" (one f32
    tensor: the ids are exact below 2**24) and the largest value wins, a
    tie going to the lowest global id, as ``jnp.argmax`` breaks it.
    Returns (...,) int64, the same on every rank of "model"."""
    tp = axis(TP)
    width = logits.shape[-1]
    lo = tp.index * width
    ids = lo + torch.arange(width, device=logits.device)
    x = torch.where(ids >= vocab_size, -torch.inf, logits.float())
    idx = x.argmax(dim=-1, keepdim=True)
    cand = torch.cat([x.gather(-1, idx), (lo + idx).float()], dim=-1)
    every = all_gather(cand[None], 0, tp.group, tp.n)     # (n, ..., 2)
    vals, gids = every[..., 0], every[..., 1]
    best = vals.amax(dim=0)
    return torch.where(vals == best, gids, torch.inf).amin(dim=0).long()
