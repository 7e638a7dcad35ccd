"""Mixture-of-Experts: prefix-stable routing + pluggable SU dispatch.

The port of ``repro/models/moe.py``.  Routing tokens to experts is a
sparse x dense product, and the layer splits into the stages that implies:

**Routing** (:func:`route_tokens`) is prefix-stable: a token's slot in its
expert's queue is a cumsum along the sequence per (row, expert), offset by an
occupancy count carried across calls, and the keep decision compares the
slot with the prefix capacity ``C(t) = ceil((t + 1) / E * capacity_factor)``
at the token's absolute position -- so a one-token decode step reproduces
the slot and drop decision the same token gets inside a prefill.

**Dispatch** -- ``"gather"`` gathers token rows into dense (E, B, C, d)
capacity tiles by the inverse index stream; ``"bcsr"`` builds the 0/1
(slot, token) dispatch matrix as a :class:`BatchedBCSR` routed stream on the
host and runs it through the SpMM kernel (K2).  The blocks are exact 0/1 and
the kernel rounds per entry as the reference does, so both backends give
bit-identical dispatch buffers.

**Two-phase serving** -- :func:`route_moe` routes on concrete activations
(:func:`route_phase1` on the device, then :func:`plan_from_phase1` on the
host) and compacts the stream to its union nonzero-block pattern (host
numpy), padded to a power-of-two nnzb bucket; :func:`execute_moe` runs
dispatch + expert FFN + combine from that plan.  ``launch.serve.ServeLoop``
drives it at every attn+moe layer.

**Fused serving** (``model.prefill`` / ``model.decode_step``) routes with
``full_grid=True``: the bcsr stream is every block of the dispatch grid,
its index stream built once a grid shape on the device and its 0/1 blocks
from the device-built dispatch matrix (:func:`_full_grid_stream`, the
reference's traced ``_dispatch_bcsr``), so nothing is read on the host and
a decode step can be captured as a CUDA graph.

**Training** goes through the gather backend (the configs' default): the
router logits (R1 on the card, with its backward), the gate and the
gather dispatch and combine carry gradients, and with ``counts=None`` no
step writes in place into anything autograd saved.  The bcsr backend's
kernel K2 has no backward and refuses inputs that require grad.

**Expert-parallel** (train-only): under ``parallel.context``'s
``MOE_IMPL == "shard_map"`` with a ``MESH``, :func:`apply_moe` runs
``models.moe_shard_map.apply_moe_shard_map``: each (batch, sequence) block
routes locally, the experts split over "model" with an all-to-all of the
capacity tiles, their weights gathered over the FSDP axes.  In the sharded
train step (``context.ACT_SPEC`` set) the params and x are already this
rank's, so ``moe_shard_map.moe_block`` runs on them directly
(:func:`_moe_local`), the shared expert beside it as the tensor-parallel
MLP.

**Under a mesh** (the serving steps; ``context.MOE_SPEC`` and ``MESH``
set, ``MOE_IMPL`` not "shard_map"), :func:`apply_moe` is the reference's
pjit layer on this rank's part of its ``MOE_SPEC`` layout: whole rows
routed (the stream gathered over "model" under sequence parallelism),
the dispatch buffer of the rank's E / tp experts and rows by either
backend, the expert products on them, their outputs all-gathered over
"model" and combined in the ``MOE_COMBINE_SPEC`` layout
(:func:`_apply_moe_mesh`).

The backend is ``dispatch=``, else ``parallel.context.MOE_DISPATCH``, else
the config's ``moe_dispatch``.  ``groups=`` (else
``parallel.context.MOE_GROUPS``) declares the dispatch row groups the data
axes expect; one that does not divide the batch warns (raises under
``cfg.moe_strict_dispatch``).
"""
from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.formats import BatchedBCSR
from repro_torch.core.precision import QuantTensor, quantize_tensor
from repro_torch.kernels import build, engine, tuning
from repro_torch.kernels.router.kernel import router_logits
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import apply_mlp, init_mlp, normal
from repro_torch.parallel import context


def init_moe(g: torch.Generator, cfg: ArchConfig, *, n: int, dtype, device):
    """Stacked (n,) MoE params; the router stays f32 (routing multiplies in
    f32), expert matrices are stored in ``dtype``."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = d ** -0.5
    kw = dict(n=n, dtype=dtype, device=device)
    p = {"router": normal(g, (d, E), s, n=n, dtype=torch.float32,
                          device=device)}
    if cfg.mlp_type == "swiglu":
        p["experts"] = {"w_gate": normal(g, (E, d, ff), s, **kw),
                        "w_up": normal(g, (E, d, ff), s, **kw),
                        "w_down": normal(g, (E, ff, d), ff ** -0.5, **kw)}
    else:
        p["experts"] = {"w_up": normal(g, (E, d, ff), s, **kw),
                        "w_down": normal(g, (E, ff, d), ff ** -0.5, **kw)}
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(g, cfg, n=n, dtype=dtype, device=device)
    return p


def _wcast(w, cd: torch.dtype) -> torch.Tensor:
    """Weight accessor of the expert products: a BlockQuant weight
    (:class:`QuantTensor`) dequantized, narrow values times its f32 scales
    then cast to ``cd`` as ``QuantTensor.dequantize`` does; a wide one cast.
    The scales multiply the widened values in place, so one f32 matrix is
    made, not two.  Called at each ``bmm``, so one matrix is dequantized
    at a time."""
    if isinstance(w, QuantTensor):
        s = w.scales.unsqueeze(w.axis).float()
        return w.values.float().mul_(s).to(cd)
    return w.to(cd)


def _expert_ffn(experts, xe: torch.Tensor, mlp_type: str) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d), batched over the expert dim; each
    weight through :func:`_wcast`."""
    cd = xe.dtype
    if mlp_type == "swiglu":
        h = F.silu(torch.bmm(xe, _wcast(experts["w_gate"], cd)))
        h = h * torch.bmm(xe, _wcast(experts["w_up"], cd))
    else:
        h = torch.square(F.relu(torch.bmm(xe, _wcast(experts["w_up"], cd))))
    return torch.bmm(h, _wcast(experts["w_down"], cd))


def quantize_expert_weights(params, dtype):
    """BlockQuant of one MoE slot's expert weights (the reference's
    ``quantize_expert_weights`` with its default nearest rounding): each
    ``experts`` leaf ``(..., E, d_in, d_out)`` becomes a
    :class:`QuantTensor` with one f32 scale per (expert, output channel),
    over the contraction axis -2 (negative, so a repeat-stacked leaf sliced
    by ``model._take`` keeps its axis).  The router and the shared expert
    stay as they are.  Returns a new params dict (the input unchanged)."""
    if "experts" not in params:
        raise ValueError(
            f"quantize_expert_weights: params has no 'experts' subtree "
            f"(keys: {sorted(params)})")
    out = dict(params)
    out["experts"] = {k: _quantize_matrices(w, dtype)
                      for k, w in params["experts"].items()}
    return out


def _quantize_matrices(w: torch.Tensor, dtype) -> QuantTensor:
    """``quantize_tensor(w, dtype, axis=-2)`` one (d_in, d_out) matrix at a
    time (the scales of one never depend on another, so the bits are the
    same), so that the f32 temporaries are one matrix's, not the whole
    stack's (scout's stacked expert leaf is 10.7 GB of bf16)."""
    mats = w.reshape(-1, *w.shape[-2:])
    qs = [quantize_tensor(m, dtype, axis=-2) for m in mats]
    return QuantTensor(
        values=torch.stack([q.values for q in qs]).reshape(w.shape),
        scales=torch.stack([q.scales for q in qs]).reshape(
            *w.shape[:-2], w.shape[-1]),
        axis=-2)


def quantize_model_experts(params, dtype):
    """:func:`quantize_expert_weights` on every attn+moe slot of a model's
    params (``blocks``, and ``prologue`` where there is one).  Raises where
    no slot has experts: a silent no-op would pass for a memory saving."""
    def q_slot(slot):
        if isinstance(slot, dict) and isinstance(slot.get("ffn"), dict) \
                and "experts" in slot["ffn"]:
            s = dict(slot)
            s["ffn"] = quantize_expert_weights(slot["ffn"], dtype)
            return s, True
        return slot, False

    out = dict(params)
    hit = False
    if "blocks" in params:
        slots = []
        for slot in params["blocks"]:
            s, h = q_slot(slot)
            hit |= h
            slots.append(s)
        out["blocks"] = tuple(slots)
    if "prologue" in params:
        out["prologue"], h = q_slot(params["prologue"])
        hit |= h
    if not hit:
        raise ValueError(
            "quantize_model_experts: no attn+moe slot with an 'experts' "
            "subtree found in params")
    return out


# ----------------------------------------------------------------- routing --

class Routing(NamedTuple):
    """Per-token routing decision (all leading dims (B, S))."""
    gate: torch.Tensor        # f32 top-1 router probability
    expert_id: torch.Tensor   # int32 assigned expert
    slot: torch.Tensor        # int32 absolute position in the (row, expert) queue
    within: torch.Tensor      # int32 queue position within THIS call
    keep: torch.Tensor        # bool  slot < prefix capacity at the token's position
    new_counts: torch.Tensor  # (B, E) int32 occupancy after this call
    logits: torch.Tensor      # (B, S, E) f32 router logits


def prefix_capacity(t: torch.Tensor, n_experts: int,
                    capacity_factor: float) -> torch.Tensor:
    """``ceil((t+1)/E * capacity_factor)`` with the multiply in f32, exactly
    as the reference computes it (the factor is rounded to f32 first)."""
    t1 = (t.to(torch.int32) + 1).float()
    return torch.ceil(t1 * float(np.float32(capacity_factor / n_experts))
                      ).to(torch.int32)


def dispatch_capacity(S: int, cfg: ArchConfig, pos0=0) -> int:
    """Static capacity of the dispatch buffer for an S-token call starting at
    absolute position ``pos0``: kept tokens satisfy ``within < S`` and
    ``slot < C(pos0 + S - 1)``; same f32 arithmetic as
    :func:`prefix_capacity`, so the bound is never under the keep test.  A
    per-row ``(B,)`` vector ``pos0`` (continuous batching) takes the
    position-independent S bound, one int for the batch, as the reference
    does; for a decode step both give 1."""
    if not isinstance(pos0, (int, np.integer)):
        return max(1, S)
    cap = int(np.ceil(np.float32(pos0 + S)
                      * np.float32(cfg.capacity_factor / cfg.n_experts)))
    return max(1, min(S, cap))


def route_tokens(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig, *,
                 counts: Optional[torch.Tensor] = None,
                 pos0=0) -> Routing:
    """Top-1 routing with prefix-stable slot assignment.

    x: (B, S, d); ``counts``: (B, E) int32 occupancy from previous calls on
    the same rows (None = fresh sequence); ``pos0``: absolute position of
    x[:, 0], an int shared by the batch or a ``(B,)`` int tensor of per-row
    positions (continuous batching), when the keep test runs per row.  Ties
    go to the lowest expert index, as ``jax.lax.top_k`` does (``argmax``
    returns the first maximum).  The logits come from
    ``kernels.router.kernel.router_logits``: on the card the kernel R1,
    whose f32 sum over d has one order for every token however many are
    routed together (prefill, decode, any batch bucket); on the CPU the
    reference's product."""
    B, S, _ = x.shape
    E = cfg.n_experts
    logits = router_logits(x, router)                             # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    expert_id = torch.argmax(probs, dim=-1)
    gate = torch.gather(probs, -1, expert_id[..., None])[..., 0]
    expert_id = expert_id.to(torch.int32)
    onehot = F.one_hot(expert_id.long(), E).to(torch.int32)       # (B, S, E)
    if counts is None:
        counts = torch.zeros((B, E), dtype=torch.int32, device=x.device)
    # queue position = prior same-(row, expert) tokens, kept OR dropped
    within = ((torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot)
              * onehot).sum(-1, dtype=torch.int32)
    base = (counts[:, None, :] * onehot).sum(-1, dtype=torch.int32)
    slot = base + within
    t_abs = torch.arange(S, dtype=torch.int32, device=x.device)
    if isinstance(pos0, torch.Tensor):
        t_abs = pos0.to(torch.int32).reshape(B, 1) + t_abs       # (B, S)
    else:
        t_abs = pos0 + t_abs                                      # (S,)
    cap = prefix_capacity(t_abs, E, cfg.capacity_factor)
    keep = slot < (cap if cap.dim() == 2 else cap[None, :])
    new_counts = counts + onehot.sum(dim=1, dtype=torch.int32)
    return Routing(gate, expert_id, slot, within, keep, new_counts, logits)


# ---------------------------------------------------------------- dispatch --

def _dispatch_gather(xt: torch.Tensor, flat_slot: torch.Tensor, E: int,
                     C: int) -> torch.Tensor:
    """SU indirection dispatch: inverse index stream + gather.
    xt: (B, S, d); flat_slot: (B, S) in [0, E*C] (E*C = dropped).
    Returns (E, B, C, d) capacity tiles."""
    B, S, d = xt.shape
    inv = torch.full((B, E * C + 1), S, dtype=torch.long, device=xt.device)
    inv.scatter_(1, flat_slot.long(),
                 torch.arange(S, device=xt.device).expand(B, S))
    inv = inv[:, :E * C]
    xt_pad = torch.cat([xt, xt.new_zeros((B, 1, d))], dim=1)
    xe = torch.gather(xt_pad, 1, inv[..., None].expand(B, E * C, d))
    return xe.reshape(B, E, C, d).transpose(0, 1)


def _dispatch_grid(S: int, E: int, C: int, bm: int, bk: int):
    """The padded block geometry of the (slot, token) dispatch matrix:
    (M, Mp, Sp, gm, gn)."""
    M = E * C
    Mp = -(-M // bm) * bm
    Sp = -(-S // bk) * bk
    return M, Mp, Sp, Mp // bm, Sp // bk


def _build_routed_stream(flat_slot, S: int, E: int, C: int, bm: int, bk: int,
                         dtype: torch.dtype, device,
                         min_bucket: Optional[int] = None):
    """Compacted dispatch stream from *concrete* slots, built on the host.

    Union nonzero-block pattern over the batch, every block-row present
    (a zero block at col 0 for an empty row), (row, col)-sorted.  Cost is
    O(B*S + nnzb*bm*bk) host numpy; the finished stream is uploaded once.
    ``min_bucket`` pads the stream to its power-of-two bucket; pad entries
    repeat the last coordinate with zero blocks, so ``indptr`` counts them
    in the last row.

    Returns (BatchedBCSR, nnzb_routed, nnzb_covered): data blocks before
    row coverage, and the covered (pre-bucket) stream length."""
    fs = np.asarray(flat_slot)
    B = fs.shape[0]
    M, Mp, Sp, gm, gn = _dispatch_grid(S, E, C, bm, bk)
    if fs.size and (fs.min() < 0 or fs.max() > M):
        raise ValueError(
            f"_build_routed_stream: flat_slot out of range "
            f"[{int(fs.min())}, {int(fs.max())}] vs dispatch grid M={M}")
    b_idx, s_idx = np.nonzero(fs < M)        # kept tokens (dropped = M)
    slots = fs[b_idx, s_idx]
    keys = (slots // bm).astype(np.int64) * gn + s_idx // bk
    coords = np.unique(keys)                  # sorted == (row, col)-sorted
    nnzb_routed = len(coords)
    present = np.zeros(gm, bool)
    present[(coords // gn).astype(np.int32)] = True
    coords = np.union1d(coords,
                        np.nonzero(~present)[0].astype(np.int64) * gn)
    nnzb_covered = len(coords)
    idx = np.searchsorted(coords, keys)       # before any bucket padding
    cap = nnzb_covered
    if min_bucket is not None:
        cap = engine.stream_bucket(nnzb_covered, minimum=min_bucket)
        coords = np.concatenate(
            [coords, np.full(cap - nnzb_covered, coords[-1])])
    brows = (coords // gn).astype(np.int32)
    bcols = (coords % gn).astype(np.int32)
    blocks = np.zeros((B, cap, bm, bk), np.float32)
    blocks[b_idx, idx, slots % bm, s_idx % bk] = 1
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum(np.bincount(brows, minlength=gm), out=indptr[1:])
    stream = BatchedBCSR(
        indptr=_upload(indptr, device), block_rows=_upload(brows, device),
        block_cols=_upload(bcols, device),
        blocks=_upload(blocks, device).to(dtype),
        shape=(B, Mp, Sp), block=(bm, bk))
    return stream, nnzb_routed, nnzb_covered


@functools.lru_cache(maxsize=None)
def _grid_index(gm: int, gn: int, device: torch.device):
    """``(indptr, block_rows, block_cols)`` of the full ``(gm, gn)`` block
    grid, (row, col)-sorted, int32 on ``device``: every block row and
    column, ``indptr`` from their counts (``gn`` a row).  Built on the
    device once a (grid, device) and kept."""
    entry = torch.arange(gm * gn, device=device)
    brows = torch.div(entry, gn, rounding_mode="floor").to(torch.int32)
    bcols = (entry % gn).to(torch.int32)
    indptr = torch.arange(gm + 1, dtype=torch.int32, device=device) * gn
    return indptr, brows, bcols


def _full_grid_stream(flat_slot: torch.Tensor, S: int, E: int, C: int,
                      bm: int, bk: int, dtype: torch.dtype) -> BatchedBCSR:
    """The full-grid dispatch stream of the fused path, on the device with
    no host read: the (slot, token) 0/1 dispatch matrix of each batch row,
    zero-padded to block multiples, tiled into every ``(bm, bk)`` block of
    the ``(gm, gn)`` grid in (row, col) order; a dropped token writes the
    sliced-off row ``Mp``, so it is in no block.  Every block row is in the
    stream, so it is normalized for ``engine.spmm_batched_stream``.  The
    port of the reference's traced ``_dispatch_bcsr`` with
    ``_dispatch_matrix_tiles``."""
    B = flat_slot.shape[0]
    M, Mp, Sp, gm, gn = _dispatch_grid(S, E, C, bm, bk)
    rows = torch.where(flat_slot < M, flat_slot, Mp).long()
    disp = torch.zeros((B, Mp + 1, Sp), dtype=dtype, device=flat_slot.device)
    disp.scatter_(1, rows[:, None, :], 1)
    blocks = (disp[:, :Mp].reshape(B, gm, bm, gn, bk).transpose(2, 3)
              .reshape(B, gm * gn, bm, bk).contiguous())
    indptr, brows, bcols = _grid_index(gm, gn, flat_slot.device)
    return BatchedBCSR(indptr=indptr, block_rows=brows, block_cols=bcols,
                       blocks=blocks, shape=(B, Mp, Sp), block=(bm, bk))


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: to a CUDA
    device through pinned memory with a ``non_blocking`` copy (the caching
    host allocator keeps the pinned buffer until the copy has run)."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _dispatch_stream(xt: torch.Tensor, stream: BatchedBCSR, E: int,
                     C: int) -> torch.Tensor:
    """Dispatch-as-SpMM: a routed BatchedBCSR stream x the token block
    through the SpMM kernel.  Returns (E, B, C, d), bit-identical to
    :func:`_dispatch_gather` (0/1 blocks)."""
    B, S, d = xt.shape
    _, Mp, Sp = stream.shape
    tiles = tuning.moe_dispatch_tiles(d, xt.dtype, xt.device)
    xt_p = F.pad(xt, (0, 0, 0, Sp - S))
    out = engine.spmm_batched_stream(stream, xt_p, bn=tiles["bn"],
                                     out_dtype=xt.dtype)      # (B, Mp, d)
    return out[:, :E * C].reshape(B, E, C, d).transpose(0, 1)


def _combine_gather(yt: torch.Tensor, flat_slot: torch.Tensor,
                    gate: torch.Tensor, keep: torch.Tensor, E: int,
                    C: int) -> torch.Tensor:
    """Gather each token's expert output back by its own index; dropped
    tokens contribute zero.  yt: (B, E*C, d) -> (B, S, d)."""
    B, _, d = yt.shape
    yt_pad = torch.cat([yt, yt.new_zeros((B, 1, d))], dim=1)
    idx = torch.clamp(flat_slot.long(), max=E * C)
    back = torch.gather(yt_pad, 1, idx[..., None].expand(-1, -1, d))
    return back * (gate * keep).to(back.dtype)[..., None]


def _moe_tail(p, x, xe, gate, keep, flat_slot, cfg: ArchConfig, E: int,
              C: int) -> torch.Tensor:
    """Expert FFN + combine (+ shared expert): everything downstream of the
    dispatch buffer, shared by :func:`apply_moe` and :func:`execute_moe`.
    The reshape copies the (E, B, C, d) buffer to one contiguous layout, so
    both dispatch backends feed the expert GEMMs identical operands."""
    B, S, d = x.shape
    ye = _expert_ffn(p["experts"], xe.reshape(E, B * C, d),
                     cfg.mlp_type).reshape(E, B, C, d)
    yt = ye.transpose(0, 1).reshape(B, E * C, d)
    out = _combine_gather(yt, flat_slot, gate, keep, E, C)
    if cfg.moe_shared_expert:
        out = out + apply_mlp(p["shared"], x.reshape(B * S, d),
                              cfg).reshape(B, S, d)
    return out


def _backend(cfg: ArchConfig, dispatch: Optional[str]) -> str:
    """``dispatch``, else ``context.MOE_DISPATCH``, else the config's."""
    backend = dispatch or context.MOE_DISPATCH or cfg.moe_dispatch
    if backend not in ("gather", "bcsr"):
        raise ValueError(f"unknown moe_dispatch backend {backend!r}")
    return backend


def _check_groups(B: int, cfg: ArchConfig, G: Optional[int], who: str):
    """Warn (raise under ``cfg.moe_strict_dispatch``) when ``G`` dispatch
    row groups do not divide the batch."""
    if G and B % G != 0:
        msg = (f"{who}: {G} dispatch group(s) requested but the batch "
               f"dim B={B} is not divisible; routing is per batch row, so "
               "the layer's result is the same, but the groups cannot "
               "each hold whole rows of the data shards.")
        if cfg.moe_strict_dispatch:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)


def _apply_moe_shard_map(p, x: torch.Tensor, cfg: ArchConfig, counts, pos,
                         dispatch: Optional[str]):
    """:func:`apply_moe`'s expert-parallel branch over ``context.MESH``:
    the FSDP axes present (merged when there are two) and "model".  It
    threads no routing state and dispatches by gather only, so a caller
    with ``counts`` / ``pos`` or another backend is warned (refused under
    ``cfg.moe_strict_dispatch``).  Returns ``(out, counts or zeros (B,
    E))``."""
    from repro_torch.models.moe_shard_map import apply_moe_shard_map
    from repro_torch.parallel.sharding import FSDP, TP
    if counts is not None or pos is not None or \
            _backend(cfg, dispatch) != "gather":
        msg = ("apply_moe: the shard_map impl is train-only -- it does "
               "not thread routing occupancy (counts/pos) and only "
               "supports moe_dispatch='gather'; decode and bcsr callers "
               "must use the pjit impl.")
        if cfg.moe_strict_dispatch:
            raise ValueError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    mesh = context.MESH
    dp_axes = tuple(a for a in FSDP if a in mesh.mesh_dim_names)
    dp_axes = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    if context.ACT_SPEC is not None:
        out = _moe_local(p, x, cfg, mesh, dp_axes)
    else:
        out = apply_moe_shard_map(p, x, cfg, mesh, dp_axes=dp_axes,
                                  tp_axis=TP)
    if counts is None:
        counts = torch.zeros((x.shape[0], cfg.n_experts), dtype=torch.int32,
                             device=x.device)
    return out, counts


def _moe_local(p, x: torch.Tensor, cfg: ArchConfig, mesh, dp_axes):
    """The expert-parallel layer in the sharded train step
    (``context.ACT_SPEC``): ``p`` is this rank's, the router whole, the
    experts in ``moe_block``'s layout (their ``param_specs``), the shared
    expert's "model" share; x the residual stream's layout.  Under
    sequence parallelism x is already ``moe_block``'s (B_loc, S/tp, d)
    block; without, x (B_loc, S, d) is replicated over "model", so the
    rank's sequence block is cut out (its gradient gathered back) and the
    blocks assembled after.  The shared expert runs beside as the
    tensor-parallel MLP on x."""
    from repro_torch.models.moe_shard_map import moe_block
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import TP
    routed = {"router": p["router"], "experts": p["experts"]}
    if C.seq_parallel():
        out = moe_block(routed, x, cfg, mesh, dp_axes=dp_axes, tp_axis=TP)
    else:
        tp = C.axis(TP)
        blk = C.Split.apply(x, 1, tp.group, tp.n, tp.index)
        out = moe_block(routed, blk, cfg, mesh, dp_axes=dp_axes, tp_axis=TP)
        out = C.Assemble.apply(out, 1, tp.group, tp.n, tp.index)
    if cfg.moe_shared_expert:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out


def _dispatch_rows(x: torch.Tensor, local_slot: torch.Tensor, n: int,
                   C: int, backend: str) -> torch.Tensor:
    """The (n, B, C, d) dispatch buffer of ``n`` experts from slots
    ``local_slot`` (B, S) in [0, n * C] (n * C: not these experts'), by
    ``backend``: the gather, or K2 on the full-grid stream built on the
    device (no host read, as the fused path's).  Each is a copy, equal
    bit for bit."""
    if backend == "gather":
        return _dispatch_gather(x, local_slot, n, C)
    build.refuse_grad("moe bcsr dispatch (K2; train with dispatch="
                      "'gather')", x)
    bm, bk = tuning.moe_dispatch_tiles(x.shape[-1], x.dtype,
                                       x.device)["block"]
    stream = _full_grid_stream(local_slot, x.shape[1], n, C, bm, bk,
                               x.dtype)
    return _dispatch_stream(x, stream, n, C)


def _apply_moe_mesh(p, x: torch.Tensor, cfg: ArchConfig, counts, pos,
                    dispatch: Optional[str], groups: Optional[int]):
    """:func:`apply_moe` under ``context.MOE_SPEC`` with a
    ``context.MESH`` (the serving steps on a mesh): the reference's pjit
    layer on this rank's part of its (E, B, C, d) layout, its E / tp
    experts (``MOE_SPEC``'s first axis) for its rows.

    ``x`` is the residual stream's layout: the rank's rows, under sequence
    parallelism its block of the positions, gathered over "model" first
    so that every row routes whole (a token's expert, slot, keep and gate
    are one device's).  ``p`` is the layer's params as
    ``launch.steps.layer_gather`` gives them: the router whole, the rank's
    experts with their FSDP shards gathered, the shared expert's "model"
    share.  ``counts`` (B_loc, E) and ``pos`` are the rank's rows';
    ``context.ACT_SPEC``'s batch entry splits the rows, so ``groups`` is
    checked against the global batch, as the reference's layer checks
    it.

    The dispatch buffer is the rank's slice of one device's
    (:func:`_dispatch_rows`, a copy).  The experts' outputs are
    all-gathered over their axis and combined in the row-sharded layout
    (``MOE_COMBINE_SPEC``, which must leave the slots and d whole: no
    all-reduce of partial combines); the rank's sequence block is cut back
    out and the shared expert added as the tensor-parallel MLP on the
    stream.  Returns (out in ``x``'s layout, the rows' new counts (B_loc,
    E))."""
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import TP
    combine = context.MOE_COMBINE_SPEC
    if combine is not None and tuple(combine[1:]) != (None, None):
        raise ValueError(f"apply_moe: MOE_COMBINE_SPEC {combine!r} splits "
                         "the slots or d; the layer combines whole rows of "
                         "(B, E*C, d)")
    tp, ep = C.axis(TP), C.axis(context.MOE_SPEC[0])   # sequence, experts
    B_loc, S_loc, d = x.shape
    rows = context.ACT_SPEC[0] if context.ACT_SPEC is not None else None
    n_rows = 1 if rows is None else C.axis(rows).n
    _check_groups(B_loc * n_rows, cfg, groups, "apply_moe")
    xw = C.all_gather(x, 1, tp.group, tp.n) if C.seq_parallel() else x
    E, S = cfg.n_experts, xw.shape[1]
    n = E // ep.n
    pos0 = 0 if pos is None else pos
    if not isinstance(pos0, torch.Tensor):
        pos0 = int(pos0)
    cap = dispatch_capacity(S, cfg, pos0=pos0)
    gate, keep, new_counts, flat_slot = route_phase1(p["router"], xw, cfg,
                                                     counts, pos0, cap)
    lo = ep.index * n * cap
    mine = (flat_slot >= lo) & (flat_slot < lo + n * cap)
    local_slot = torch.where(mine, flat_slot - lo, n * cap)
    xe = _dispatch_rows(xw, local_slot, n, cap, _backend(cfg, dispatch))
    ye = _expert_ffn(p["experts"], xe.reshape(n, B_loc * cap, d),
                     cfg.mlp_type).reshape(n, B_loc, cap, d)
    ye = C.all_gather(ye, 0, ep.group, ep.n)          # (E, B_loc, C, d)
    yt = ye.transpose(0, 1).reshape(B_loc, E * cap, d)
    out = _combine_gather(yt, flat_slot, gate, keep, E, cap)
    if C.seq_parallel():
        out = out[:, tp.index * S_loc:(tp.index + 1) * S_loc]
    if cfg.moe_shared_expert:
        out = out + apply_mlp(p["shared"], x, cfg)
    return out, new_counts


def apply_moe(p, x: torch.Tensor, cfg: ArchConfig, *,
              counts: Optional[torch.Tensor] = None, pos=None,
              groups: Optional[int] = None, dispatch: Optional[str] = None,
              full_grid: bool = False):
    """x: (B, S, d) -> ((B, S, d), new_counts (B, E) int32), the one-call
    layer: :func:`route_moe` then :func:`execute_moe`.  ``counts``/``pos``
    thread the routing state for stepwise decode (``pos`` a Python int, or
    per-row positions, see :func:`route_moe`).
    ``dispatch``: "gather" | "bcsr" (default: ``context.MOE_DISPATCH``,
    then the config's ``moe_dispatch``).  The bcsr stream is compacted on
    the host and bucketed (its pad entries are zero blocks, so the result
    is the unbucketed stream's); ``full_grid=True`` (the fused path) takes
    the full-grid stream instead, built on the device (:func:`route_moe`).
    Both equal gather bit for bit.  ``groups``: see the module docstring.
    Under ``context.MOE_IMPL == "shard_map"`` with a ``context.MESH`` the
    expert-parallel layer runs instead (:func:`_apply_moe_shard_map`);
    else under ``context.MOE_SPEC`` with a ``context.MESH`` the layer on
    this rank's experts and rows (:func:`_apply_moe_mesh`; bcsr there
    always on the full grid)."""
    if context.MOE_IMPL == "shard_map" and context.MESH is not None:
        return _apply_moe_shard_map(p, x, cfg, counts, pos, dispatch)
    groups = groups or context.MOE_GROUPS
    if context.MOE_SPEC is not None and context.MESH is not None:
        return _apply_moe_mesh(p, x, cfg, counts, pos, dispatch, groups)
    _check_groups(x.shape[0], cfg, groups, "apply_moe")
    plan, _ = _route_moe(p, x, cfg, counts, pos, dispatch, full_grid)
    return execute_moe(p, x, plan, cfg)


# ------------------------------------------------- two-phase serving API --

def route_phase1(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig,
                 counts: Optional[torch.Tensor], pos0, capacity: int):
    """The device half of phase 1: router matmul, top-1 and the
    prefix-stable slot cumsums (``pos0`` an int or a ``(B,)`` int tensor of
    per-row positions), returning only the small per-token routing
    tensors ``(gate, keep, new_counts, flat_slot)`` -- never the hidden
    state.  ``flat_slot`` encodes a kept token's dispatch row
    ``expert * capacity + within`` and a dropped one as ``E * capacity``.
    The pipelined serving path dispatches it with the attention half of
    its layer (``model``'s ``route_ahead``), ahead of the host route."""
    r = route_tokens(router, x, cfg, counts=counts, pos0=pos0)
    flat_slot = torch.where(r.keep, r.expert_id * capacity + r.within,
                            cfg.n_experts * capacity)
    return r.gate, r.keep, r.new_counts, flat_slot


class Phase1(NamedTuple):
    """Phase-1 routing outputs plus the dispatch capacity their slots
    encode; consumed by :func:`plan_from_phase1`."""
    gate: torch.Tensor        # (B, S) f32 top-1 router probability
    keep: torch.Tensor        # (B, S) bool prefix-capacity keep set
    new_counts: torch.Tensor  # (B, E) int32 occupancy after this call
    flat_slot: torch.Tensor   # (B, S) int32 in [0, E*C]  (E*C = dropped)
    capacity: int             # dispatch capacity C the slots encode


@dataclasses.dataclass(frozen=True)
class MoEPlan:
    """Phase-1 output of two-phase serving: exactly what phase 2 consumes."""
    gate: torch.Tensor
    keep: torch.Tensor
    new_counts: torch.Tensor
    flat_slot: torch.Tensor
    stream: Optional[BatchedBCSR]  # routed dispatch stream ("bcsr") | None
    capacity: int
    backend: str                   # "gather" | "bcsr"


def route_moe(p, x: torch.Tensor, cfg: ArchConfig, *,
              counts: Optional[torch.Tensor] = None, pos=None,
              groups: Optional[int] = None, dispatch: Optional[str] = None,
              full_grid: bool = False) -> Tuple[MoEPlan, dict]:
    """Phase 1: route a concrete ``x`` and, for "bcsr", build the routed
    dispatch stream (union nonzero-block pattern, bucketed).  ``pos`` is
    the absolute position of x[:, 0]: None (0), an int, or a ``(B,)`` int
    tensor of per-row positions on ``x``'s device (the dispatch capacity
    then takes the position-independent S bound).  Returns
    ``(plan, info)``; ``info`` holds the stream accounting (``nnzb_routed``,
    ``nnzb_covered``, ``nnzb_stream``, ``grid_nnzb``, ``bucket``) and the
    host timing split (``wait_s`` fetching the slots, ``host_s`` building).
    ``full_grid=True`` with "bcsr": the stream is the full grid
    (:func:`_full_grid_stream`), built on the device; nothing is read on
    the host, and ``info`` holds only the backend, capacity, tokens and
    ``nnzb_stream`` / ``grid_nnzb`` (the grid's blocks).  ``groups``:
    see the module docstring."""
    _check_groups(x.shape[0], cfg, groups or context.MOE_GROUPS,
                  "route_moe")
    return _route_moe(p, x, cfg, counts, pos, dispatch, full_grid)


def _route_moe(p, x: torch.Tensor, cfg: ArchConfig, counts, pos,
               dispatch: Optional[str], full_grid: bool
               ) -> Tuple[MoEPlan, dict]:
    """:func:`route_moe` without the groups check."""
    backend = _backend(cfg, dispatch)
    pos0 = 0 if pos is None else pos
    if not isinstance(pos0, torch.Tensor):
        pos0 = int(pos0)
    C = dispatch_capacity(x.shape[1], cfg, pos0=pos0)
    ph1 = Phase1(*route_phase1(p["router"], x, cfg, counts, pos0, C), C)
    if not (full_grid and backend == "bcsr"):
        return plan_from_phase1(ph1, cfg, dispatch=backend, dtype=x.dtype,
                                device=x.device)
    bm, bk = tuning.moe_dispatch_tiles(cfg.d_model, x.dtype,
                                       x.device)["block"]
    stream = _full_grid_stream(ph1.flat_slot, x.shape[1], cfg.n_experts, C,
                               bm, bk, x.dtype)
    plan = MoEPlan(gate=ph1.gate, keep=ph1.keep, new_counts=ph1.new_counts,
                   flat_slot=ph1.flat_slot, stream=stream, capacity=C,
                   backend=backend)
    return plan, {"backend": backend, "capacity": C, "tokens": x.shape[1],
                  "nnzb_stream": stream.nnzb, "grid_nnzb": stream.nnzb}


def plan_from_phase1(phase1: Phase1, cfg: ArchConfig, *,
                     dispatch: Optional[str] = None,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> Tuple[MoEPlan, dict]:
    """The host half of phase 1: fetch the (B, S) slot stream -- the only
    device-to-host transfer, the hidden state never crosses -- compact it to
    the routed :class:`BatchedBCSR` stream, pad it to its bucket, upload
    it to ``device`` (default: the device of the phase-1 tensors)."""
    backend = _backend(cfg, dispatch)
    gate, keep, new_counts, flat_slot, C = phase1
    device = flat_slot.device if device is None else device
    S = flat_slot.shape[1]
    E = cfg.n_experts
    stream = None
    info = {"backend": backend, "capacity": C, "tokens": S,
            "wait_s": 0.0, "host_s": 0.0}
    if backend == "bcsr":
        t0 = time.monotonic()
        fs = flat_slot.cpu().numpy()
        t1 = time.monotonic()
        tiles = tuning.moe_dispatch_tiles(cfg.d_model, dtype, device)
        bm, bk = tiles["block"]
        stream, nnzb_routed, nnzb_covered = _build_routed_stream(
            fs, S, E, C, bm, bk, dtype, device,
            min_bucket=tiles["min_bucket"])
        gm, gn = stream.grid_shape
        info.update(nnzb_routed=nnzb_routed, nnzb_covered=nnzb_covered,
                    nnzb_stream=stream.nnzb, grid_nnzb=gm * gn,
                    bucket=stream.nnzb, block=(bm, bk),
                    wait_s=t1 - t0, host_s=time.monotonic() - t1)
    plan = MoEPlan(gate=gate, keep=keep, new_counts=new_counts,
                   flat_slot=flat_slot, stream=stream, capacity=C,
                   backend=backend)
    return plan, info


def execute_moe(p, x: torch.Tensor, plan: MoEPlan, cfg: ArchConfig):
    """Phase 2: dispatch + expert FFN + combine from a phase-1 plan; equal
    to ``apply_moe(..., dispatch=plan.backend)`` on the same inputs."""
    E, C = cfg.n_experts, plan.capacity
    if plan.backend == "bcsr":
        build.refuse_grad("moe bcsr dispatch (K2; train with dispatch="
                          "'gather')", x)
        xe = _dispatch_stream(x, plan.stream, E, C)
    else:
        xe = _dispatch_gather(x, plan.flat_slot, E, C)
    out = _moe_tail(p, x, xe, plan.gate, plan.keep, plan.flat_slot, cfg, E, C)
    return out, plan.new_counts


def load_balance_loss(logits: torch.Tensor, expert_id: torch.Tensor,
                      E: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E x sum over experts of (the fraction
    of tokens routed there) x (the mean router probability), over the
    leading dim of ``logits`` (T, E) and ``expert_id`` (T,)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac = F.one_hot(expert_id.long(), E).float().mean(dim=0)
    return E * torch.sum(frac * probs.mean(dim=0))
