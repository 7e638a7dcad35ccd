"""Param and state trees: nested dicts, tuples, lists and NamedTuples of
tensors, walked in ``jax.tree`` order.

The reference keeps params, gradients and optimizer state as JAX pytrees;
the port keeps the same trees of tensors and walks them here.  The order is
``jax.tree.flatten``'s: dict keys sorted, tuples, lists and NamedTuples in
order, and ``None`` a node without leaves.  A checkpoint numbers its leaves
in this order, so the two packages read each other's
(``checkpoint.manager``).
"""
from __future__ import annotations

from typing import Any, Callable, List


def _children(node):
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    return None


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), as ``jax.tree.map``, called in
    :func:`leaves` order; a dict keeps its key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):       # visited in sorted order, as leaves()
        out = {k: map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        out = [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):                 # a NamedTuple
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def unflatten(like, values: List[Any]):
    """``like``'s structure with its leaves replaced, in order, by
    ``values`` (as many as ``like`` has leaves)."""
    n = len(leaves(like))
    if len(values) != n:
        raise ValueError(f"unflatten: {len(values)} values for a tree of "
                         f"{n} leaves")
    it = iter(values)
    return map(lambda _: next(it), like)
