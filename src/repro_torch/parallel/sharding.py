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
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

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
