"""Expert-parallel MoE: the all-to-all dispatch over ``torch.distributed``.

The port of ``repro/models/moe_shard_map.py``.  Under pjit the combine
gather's backward is a scatter-add of model-sharded cotangents into a
data-sharded buffer, which GSPMD lowers to a full-activation all-reduce a
layer; written as an explicit all-to-all of the capacity tiles, the traffic
is bounded by those tiles in both directions, since the all-to-all's
transpose is the inverse all-to-all.

Routing is the one-device layer's own (``models.moe.route_tokens``,
``dispatch_capacity``, ``_dispatch_gather``, ``_combine_gather``) on the
*local* (B_loc, S_loc) block from local position 0, so the slot and drop
law is the per-(row, expert) prefix-cumsum law of that layer, and each
block's output is the one-device ``apply_moe`` on that block.  Train-only:
sequence parts route from local position 0 and no routing state is
threaded across calls (decode uses the one-device layer).

Layout (the reference's ``in_specs``; dp = the FSDP axes present, merged
when there are two, tp = "model"):

* x: B over dp, S over tp -- a block (B_loc, S_loc, d);
* router: replicated;
* experts: E over tp; ``w_gate`` / ``w_up`` (E, d, ff) split d over dp,
  ``w_down`` (E, ff, d) splits its last dim d over dp -- gathered over dp
  on entry (FSDP), cast to the compute dtype first;
* shared expert: dim 0 over dp, gathered the same way;
* out: B over dp, S over tp.

:func:`moe_block` is one rank's body on its local block and shards;
:func:`apply_moe_shard_map` cuts the global tensors by the rank's mesh
coordinate (:func:`local_slices`, the layout's one statement), runs it, and assembles the global output on every rank, as
the engine's ``shard_*`` do.  Every collective is a
``torch.autograd.Function`` with the transpose JAX's shard_map gives it:

* all-to-all over tp: backward, the same all-to-all (the inverse layout
  change is in the reshapes around it);
* the weights' all-gather over dp: backward, a reduce-scatter (sum) over
  dp, the gradient ZeRO-3 computes;
* a weight replicated over an axis: backward, its gradient summed over
  that axis (the router over dp and tp, the shared expert over tp);
* the output's assembly: backward, this rank's own block of the
  cotangent, never a sum over ranks.

So with the same global loss on every rank, each rank's gradient of a
global input is complete on the part of it the rank holds (the router's
everywhere) and zero elsewhere.

The collectives and their functions are ``parallel.collectives``'; they
take the group's tensors as they are: gloo takes CPU tensors and, on the
card, CUDA tensors.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_mlp
from repro_torch.models.moe import (_combine_gather, _dispatch_gather,
                                    _expert_ffn, dispatch_capacity,
                                    route_tokens)
from repro_torch.parallel.collectives import (AllToAll, Assemble, Gather,
                                              Replicated)

Axes = Union[str, Tuple[str, ...]]

# the dp-split dim of each expert matrix
_EXPERT_DP_DIM = {"w_gate": 1, "w_up": 1, "w_down": 2}


def _leaf_dims(name: str) -> tuple:
    """(dim, "dp" | "tp") for each dim of the leaf ``name`` cut over the
    mesh (the module docstring's layout)."""
    head, _, leaf = name.partition(".")
    if name == "x":
        return ((0, "dp"), (1, "tp"))
    if name == "router":
        return ()
    if head == "experts":
        return ((0, "tp"), (_EXPERT_DP_DIM[leaf], "dp"))
    if head == "shared":
        return ((0, "dp"),)
    raise KeyError(f"no layout for the leaf {name!r}")


def local_slices(name: str, shape, dp: Tuple[int, int],
                 tp: Tuple[int, int]) -> tuple:
    """The part of the global leaf ``name`` ("x", "router",
    "experts.w_gate", "shared.w_down", ...) of ``shape`` that the rank at
    ``dp`` = (size, coordinate) of the dp axes and ``tp`` = (size,
    coordinate) of the tp axis holds, as a tuple of slices: ``t[...]`` is
    the rank's view."""
    index = [slice(None)] * len(shape)
    for dim, axis in _leaf_dims(name):
        n, k = dp if axis == "dp" else tp
        w = shape[dim] // n
        index[dim] = slice(k * w, (k + 1) * w)
    return tuple(index)


def moe_block(p, x: torch.Tensor, cfg: ArchConfig, mesh, *, dp_axes: Axes,
              tp_axis: str) -> torch.Tensor:
    """One rank's expert-parallel MoE on its block: x (B_loc, S_loc, d) and
    ``p``'s local shards (the layout in the module docstring: ``router``
    whole, ``experts`` (E/tp, d/dp, ff) / (E/tp, ff, d/dp), ``shared``
    (d/dp, ff) / (ff/dp, d)) -> the block's output (B_loc, S_loc, d).
    The shared expert runs where ``p`` holds one (the sharded train step
    passes the routed experts only and runs the shared expert beside, as
    a tensor-parallel MLP)."""
    from repro_torch.launch.mesh import axes_group
    E = cfg.n_experts
    dp_group, n_dp, _ = axes_group(mesh, dp_axes)
    tp_group, n_tp, _ = axes_group(mesh, tp_axis)
    Bl, Sl, d = x.shape
    router = Replicated.apply(p["router"], (tp_group, dp_group))
    r = route_tokens(router, x, cfg)
    cap = dispatch_capacity(Sl, cfg)
    flat = torch.where(r.keep, r.expert_id * cap + r.within, E * cap)
    xe = _dispatch_gather(x, flat, E, cap).reshape(E, Bl * cap, d)
    # EP all-to-all: each tp peer gets its E/tp experts' tiles, so this rank
    # holds its experts' tokens from every sequence peer, in peer order:
    # (tp, E/tp, Bl*cap, d) received -> (E/tp, tp*Bl*cap, d)
    xe = AllToAll.apply(xe, tp_group)
    xe = xe.reshape(n_tp, E // n_tp, Bl * cap, d).transpose(0, 1) \
        .reshape(E // n_tp, n_tp * Bl * cap, d)
    cd = x.dtype
    w = {k: Gather.apply(v.to(cd), _EXPERT_DP_DIM[k], dp_group, n_dp)
         for k, v in p["experts"].items()}
    ye = _expert_ffn(w, xe, cfg.mlp_type)
    # the inverse all-to-all: each peer's tokens back to it, expert-major
    ye = ye.reshape(E // n_tp, n_tp, Bl * cap, d).transpose(0, 1) \
        .reshape(E, Bl * cap, d)
    ye = AllToAll.apply(ye, tp_group)
    yt = ye.reshape(E, Bl, cap, d).transpose(0, 1).reshape(Bl, E * cap, d)
    out = _combine_gather(yt, flat, r.gate, r.keep, E, cap)
    if "shared" in p:
        sh = {k: Gather.apply(Replicated.apply(v, (tp_group,)).to(cd),
                                   0, dp_group, n_dp)
              for k, v in p["shared"].items()}
        out = out + apply_mlp(sh, x.reshape(Bl * Sl, d), cfg) \
            .reshape(Bl, Sl, d)
    return out


def apply_moe_shard_map(p, x: torch.Tensor, cfg: ArchConfig, mesh, *,
                        dp_axes: Axes, tp_axis: str) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d) with the expert-parallel all-to-all, on
    every rank of ``mesh`` with the same global ``x`` and ``p``: this rank's
    block and shards cut by its coordinates on ``dp_axes`` and ``tp_axis``,
    :func:`moe_block`, and the blocks assembled.  B must divide over dp,
    S over tp, E over tp, and d (and the shared expert's ff) over dp;
    else it raises ``ValueError``."""
    from repro_torch.launch.mesh import axes_group
    E = cfg.n_experts
    dp_group, n_dp, i = axes_group(mesh, dp_axes)
    tp_group, n_tp, j = axes_group(mesh, tp_axis)
    B, S, d = x.shape
    splits = [("n_experts", E, n_tp), ("B", B, n_dp), ("S", S, n_tp),
              ("d_model", d, n_dp)]
    if cfg.moe_shared_expert:
        splits.append(("d_ff", cfg.d_ff, n_dp))
    for what, size, n in splits:
        if size % n:
            raise ValueError(f"apply_moe_shard_map: {what} {size} does not "
                             f"divide over {n} ranks")
    def part(name, t):
        return t[local_slices(name, t.shape, (n_dp, i), (n_tp, j))]

    local = {"router": p["router"],
             "experts": {k: part(f"experts.{k}", v)
                         for k, v in p["experts"].items()}}
    if cfg.moe_shared_expert:
        local["shared"] = {k: part(f"shared.{k}", v)
                           for k, v in p["shared"].items()}
    out = moe_block(local, part("x", x), cfg, mesh, dp_axes=dp_axes,
                    tp_axis=tp_axis)
    out = Assemble.apply(out, 1, tp_group, n_tp, j)
    return Assemble.apply(out, 0, dp_group, n_dp, i)
