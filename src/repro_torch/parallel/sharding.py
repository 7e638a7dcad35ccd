"""Sharding rules: FSDP x TP x EP x SP over the ("pod", "data", "model")
mesh, the reference's ``repro/parallel/sharding.py`` rule for rule.

* FSDP: every large parameter is sharded over the combined ("pod", "data")
  axes and over "model" (2-D sharded matrices); optimizer states mirror the
  param specs.
* TP ("model"): head / ff / vocab / expert dims.
* EP: the expert dim of MoE weights over "model".
* SP: when the batch is too small to fill the data axes (long-context
  decode), the sequence dim of caches shards over "data".

A spec is a :class:`PartitionSpec`, a tuple whose entries are a
``jax.sharding.PartitionSpec``'s: an axis name, a tuple of names, or
``None``.  Specs are derived from the param tree's paths, so any tree that
mirrors the params (gradients, AdamW's m and v) takes the same rules.  The
rules read only a mesh's axis names and sizes (``mesh_dim_names`` and
``shape``, as a ``DeviceMesh`` has them), so :class:`MeshShape` stands in
for a mesh where no process group exists.

:func:`shardings` turns a spec tree into placements, one a mesh dim
(``torch.distributed.tensor``'s ``Shard(dim)`` or ``Replicate()``; a
tuple entry such as ``("pod", "data")`` is ``Shard`` on every one of its
mesh dims, split in mesh order, row-major, as JAX merges them).
:func:`local_tree` cuts a global tree to one rank's parts and
:func:`assemble` puts the ranks' parts back together; both raise, naming
the leaf and the sizes, where a dim does not divide (no padding).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

FSDP: Tuple[str, ...] = ("pod", "data")   # present axes are filtered per mesh
TP = "model"


class PartitionSpec(tuple):
    """One entry a tensor dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, all the rules read of a mesh."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _filter(spec: P, mesh) -> P:
    """Drop mesh axes that don't exist (a single-pod mesh has no 'pod')."""
    names = set(mesh.mesh_dim_names)

    def f(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        sub = tuple(a for a in entry if a in names)
        return sub if len(sub) > 1 else (sub[0] if sub else None)

    return P(*(f(e) for e in spec))


_BASE = {
    # embeddings
    "embed": P(TP, FSDP),
    "unembed": P(FSDP, TP),
    # attention
    "wq": P(FSDP, TP), "wk": P(FSDP, TP), "wv": P(FSDP, TP),
    "wo": P(TP, FSDP),
    "bq": P(TP), "bk": P(TP), "bv": P(TP),
    # dense mlp
    "w_gate": P(FSDP, TP), "w_up": P(FSDP, TP), "w_down": P(TP, FSDP),
    # router
    "router": P(FSDP, None),
    # mamba
    "w_in": P(FSDP, TP), "w_out": P(TP, FSDP),
    "conv_w": P(None, TP), "conv_b": P(TP),
    "a_log": P(None), "d_skip": P(None), "dt_bias": P(None),
    # rwkv
    "w_r": P(FSDP, TP), "w_k": P(FSDP, TP), "w_v": P(FSDP, TP),
    "w_g": P(FSDP, TP), "w_o": P(TP, FSDP),
    "w_ck": P(FSDP, TP), "w_cv": P(TP, FSDP), "w_cr": P(FSDP, TP),
    "decay_lora_a": P(FSDP, None), "decay_lora_b": P(None, FSDP),
    "mu": P(None, FSDP), "mu_c": P(None, FSDP),
    "decay_base": P(FSDP), "bonus_u": P(None, None),
    # norms / scalars
    "scale": P(None),
}


def _rule_for(path: Tuple[str, ...], shape: Tuple[int, ...]) -> P:
    """Map a param path (dict keys along the tree) and shape to a spec.
    Stacked block params carry a leading repeat dim: a None before it."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    spec = _BASE.get(name)
    if spec is None:
        spec = P(*([None] * len(shape)))
    if parent == "experts":
        # MoE expert weights (E, d, ff): EP over model, FSDP over d / ff
        if name in ("w_gate", "w_up"):
            spec = P(TP, FSDP, None)
        elif name == "w_down":
            spec = P(TP, None, FSDP)
    if len(shape) == len(spec) + 1:
        spec = P(None, *spec)
    elif len(shape) != len(spec):
        spec = P(*([None] * len(shape)))
    return spec


def _walk(node, path, leaf):
    """``node``'s tree with ``leaf(path, x)`` at each leaf."""
    if isinstance(node, dict):
        return {k: _walk(v, path + (k,), leaf) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_walk(v, path + (str(i),), leaf)
                          for i, v in enumerate(node))
    return leaf(path, node)


def param_specs(params, mesh) -> Any:
    """The spec tree mirroring ``params``."""
    return _walk(params, (), lambda path, x: _filter(
        _rule_for(path, tuple(x.shape)), mesh))


def opt_state_specs(param_spec_tree, mesh):
    """AdamWState(m, v, count) mirrors the params; count replicated."""
    from repro_torch.optim.adamw import AdamWState
    return AdamWState(m=param_spec_tree, v=param_spec_tree, count=P())


def batch_spec(batch: int, mesh, *, seq_shard: bool = False) -> P:
    """Tokens (B, S): batch over ("pod", "data"); with ``seq_shard`` the
    sequence over "data" (SP) instead."""
    if seq_shard:
        return P(None, "data" if "data" in mesh.mesh_dim_names else None)
    return P(_filter(P(FSDP), mesh)[0], None)


def data_axis_size(mesh) -> int:
    """The ranks along the FSDP axes the mesh has."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in FSDP:
        n *= sizes.get(a, 1)
    return n


def cache_specs(cache, cfg, mesh, *, batch: int) -> Any:
    """Decode-cache specs.  The batch dim shards over ("pod", "data") when
    the batch fills them; otherwise (long context, B = 1) attention K/V
    shard their sequence over "data", ssm / wkv their head dims over
    "model"."""
    dp_size = data_axis_size(mesh)
    batch_ok = batch % dp_size == 0 and batch >= dp_size
    dp = _filter(P(FSDP), mesh)[0] if batch_ok else None

    def leaf_spec(path, x):
        name = path[-1]
        if name in ("k", "v"):
            # (L, B, Hkv, S, hd): batch over dp, sequence over "model";
            # without the batch, the sequence over "data"
            if batch_ok:
                return P(None, dp, None, TP, None)
            return P(None, None, None, "data", None)
        if name in ("ssm", "wkv"):      # (L, B, nh, hd, ns | hd)
            return P(None, dp, TP, None, None)
        if name == "conv":              # (L, B, K-1, C)
            return P(None, dp, None, TP)
        if name in ("shift_t", "shift_c"):  # (L, B, 1, d)
            return P(None, dp, None, None)
        return P(*([None] * x.dim()))

    return _walk(cache, (), lambda path, x: _filter(leaf_spec(path, x), mesh))


# ------------------------------------------------------------ placements ---

def map_specs(fn, spec_tree, *trees, path=()):
    """``fn(path, spec, *leaves)`` at every spec of ``spec_tree`` (a
    :class:`PartitionSpec` is a leaf there, not a tuple), with the matching
    leaves of ``trees``; ``None`` stays ``None``."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, PartitionSpec):
        return fn(path, spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees), path=path + (k,))
                for k, v in spec_tree.items()}
    out = [map_specs(fn, v, *(t[i] for t in trees), path=path + (str(i),))
           for i, v in enumerate(spec_tree)]
    if hasattr(spec_tree, "_fields"):                 # a NamedTuple
        return type(spec_tree)(*out)
    return type(spec_tree)(out)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names (none for ``None``)."""
    return () if entry is None else (entry,) if isinstance(entry, str) \
        else tuple(entry)


def placements(spec: P, mesh) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim ``d``'s
    entry names that mesh axis, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def shardings(spec_tree, mesh):
    """The placement tree mirroring ``spec_tree`` (:func:`placements`)."""
    return map_specs(lambda _, s: placements(s, mesh), spec_tree)


def rank_coords(mesh, rank: int) -> Dict[str, int]:
    """{axis: coordinate} of ``rank`` on a row-major mesh (the ranks of
    ``launch.mesh.make_mesh``)."""
    out = {}
    for name, n in reversed(tuple(zip(mesh.mesh_dim_names,
                                      tuple(mesh.shape)))):
        rank, out[name] = divmod(rank, n)
    return {a: out[a] for a in mesh.mesh_dim_names}


def local_index(spec: P, shape, mesh, coords: Dict[str, int],
                name: str = "a leaf") -> tuple:
    """The slices of a global tensor of ``shape`` that the rank at
    ``coords`` holds under ``spec``; raises, naming ``name`` and the sizes,
    where a dim does not divide over its axes."""
    sizes = axis_sizes(mesh)
    index = [slice(None)] * len(shape)
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = math.prod(sizes[a] for a in axes)
        if shape[d] % n:
            raise ValueError(f"{name}: dim {d} of {tuple(shape)} does not "
                             f"divide over the {n} ranks of {entry!r}")
        k = 0
        for a in axes:                      # merged row-major
            k = k * sizes[a] + coords[a]
        w = shape[d] // n
        index[d] = slice(k * w, (k + 1) * w)
    return tuple(index)


def _leaf_name(path) -> str:
    return "/".join(path) or "a leaf"


def my_coords(mesh) -> Dict[str, int]:
    """This rank's {axis: coordinate} on a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def local_tree(tree, spec_tree, mesh, coords: Optional[Dict[str, int]] = None):
    """The part of every leaf of the global ``tree`` that the rank at
    ``coords`` (default: this rank of the ``DeviceMesh``) holds under
    ``spec_tree``, each a contiguous copy (a replicated leaf too: a step
    that writes its part in place never writes the global tree)."""
    coords = my_coords(mesh) if coords is None else coords
    return map_specs(lambda path, s, t: t[local_index(
        s, t.shape, mesh, coords, _leaf_name(path))].clone(
            memory_format=torch.contiguous_format), spec_tree, tree)


def assemble(trees: List[Any], spec_tree, mesh):
    """The global tree from every rank's local tree (``trees[r]`` rank r's,
    row-major ranks): each part written to its place.  Raises where two
    ranks' copies of a replicated part differ."""
    n = len(trees)

    def leaf(path, spec, *parts):
        sizes = axis_sizes(mesh)
        shape = list(parts[0].shape)
        for d, entry in enumerate(spec):
            shape[d] *= math.prod(sizes[a] for a in entry_axes(entry))
        out = parts[0].new_empty(shape)
        seen = {}
        for r in range(n):
            idx = local_index(spec, shape, mesh, rank_coords(mesh, r),
                              _leaf_name(path))
            key = tuple((s.start, s.stop) for s in idx)
            if key in seen:
                if not torch.equal(parts[r], parts[seen[key]]):
                    raise ValueError(f"{_leaf_name(path)}: ranks {seen[key]} "
                                     f"and {r} hold different copies")
                continue
            seen[key] = r
            out[idx] = parts[r]
        return out

    return map_specs(leaf, spec_tree, *trees)
