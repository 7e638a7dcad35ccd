"""Streaming-unit (SU) ops of the port (``repro/core/su.py``): indirection,
intersection, union, joint-index write.

Plain tensor code (no kernel): fixed capacity plus an explicit count, with
``INVALID_KEY`` padding, as in the reference.  The sparse library's
showcase uses them, and sparse gradient exchange (``union_add``) builds on
them.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.formats import INVALID_KEY

_INVALID = int(INVALID_KEY)


class IntersectResult(NamedTuple):
    keys: torch.Tensor    # (cap_a,) matched keys, INVALID-padded
    pos_a: torch.Tensor   # (cap_a,) positions in a (cap_a past count)
    pos_b: torch.Tensor   # (cap_a,) positions in b of matches
    count: torch.Tensor   # () int32


class UnionResult(NamedTuple):
    keys: torch.Tensor    # (cap_a + cap_b,) union keys, INVALID-padded
    values: torch.Tensor  # (cap_a + cap_b,) add-combined values
    count: torch.Tensor   # () int32


def indirect_gather(data: torch.Tensor, indices: torch.Tensor
                    ) -> torch.Tensor:
    """SU indirection: stream ``data[indices[i]]``."""
    return data.index_select(0, indices.long())


def indirect_scatter_add(out: torch.Tensor, indices: torch.Tensor,
                         values: torch.Tensor) -> torch.Tensor:
    """SU indirect write-back with accumulate (a new tensor, as in the
    reference)."""
    return out.index_add(0, indices.long(), values)


def intersect(a_keys: torch.Tensor, b_keys: torch.Tensor) -> IntersectResult:
    """Sorted-stream intersection: matched keys plus the joint index stream
    (positions into both operands).  Both inputs ascending int32,
    INVALID-padded."""
    cap_a, cap_b = a_keys.shape[0], b_keys.shape[0]
    dev = a_keys.device
    loc = torch.searchsorted(b_keys, a_keys)
    loc_c = loc.clamp(max=cap_b - 1)
    hit = (b_keys[loc_c] == a_keys) & (a_keys != _INVALID)
    ar = torch.arange(cap_a, device=dev)
    pos_a = torch.sort(torch.where(hit, ar, _INVALID)).values
    pos_a_c = pos_a.clamp(max=cap_a - 1)
    count = hit.sum().to(torch.int32)
    valid = ar < count
    keys = torch.where(valid, a_keys[pos_a_c], _INVALID).to(torch.int32)
    pos_b = torch.where(valid, loc_c[pos_a_c], cap_b).to(torch.int32)
    pos_a = torch.where(valid, pos_a_c, cap_a).to(torch.int32)
    return IntersectResult(keys=keys, pos_a=pos_a, pos_b=pos_b, count=count)


def intersect_dot(a_keys, a_vals, b_keys, b_vals) -> torch.Tensor:
    """Sparse-sparse dot product: the sum of products over the key
    intersection (the innermost SpMSpM primitive)."""
    res = intersect(a_keys, b_keys)
    cap_a = a_keys.shape[0]
    valid = torch.arange(cap_a, device=a_keys.device) < res.count
    av = torch.where(valid, a_vals[res.pos_a.long().clamp(max=cap_a - 1)], 0)
    bv = torch.where(valid, b_vals[res.pos_b.long().clamp(
        max=b_keys.shape[0] - 1)], 0)
    return (av * bv).sum()


def union_add(a_keys, a_vals, b_keys, b_vals) -> UnionResult:
    """Sorted-stream union with add-combine (SU merge mode)."""
    keys = torch.cat([a_keys, b_keys]).to(torch.int32)
    vals = torch.cat([a_vals, b_vals])
    order = torch.argsort(keys, stable=True)
    keys, vals = keys[order], vals[order]
    n = keys.shape[0]
    invalid = keys == _INVALID
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=keys.device),
                        keys[1:] != keys[:-1]]) & ~invalid
    slot = torch.cumsum(is_new, 0) - 1
    slot = torch.where(invalid, n - 1, slot)
    count = is_new.sum().to(torch.int32)
    out_vals = vals.new_zeros(n).index_add(0, slot, torch.where(invalid, 0,
                                                                vals))
    out_keys = torch.full((n,), _INVALID, dtype=torch.int32,
                          device=keys.device)
    out_keys[slot] = torch.where(invalid, _INVALID, keys)
    idx = torch.arange(n, device=keys.device)
    out_keys = torch.where(idx < count, out_keys, _INVALID)
    out_vals = torch.where(idx < count, out_vals, 0)
    return UnionResult(keys=out_keys, values=out_vals, count=count)


def topk_sparsify(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest-magnitude entries of flattened ``x`` as a sorted
    (keys, values) stream."""
    flat = x.reshape(-1)
    idx = torch.topk(flat.abs(), k).indices
    idx = torch.sort(idx).values.to(torch.int32)
    return idx, flat[idx.long()]


def stream_densify(keys: torch.Tensor, values: torch.Tensor,
                   count: torch.Tensor, size: int) -> torch.Tensor:
    """Scatter a (keys, values, count) stream back to a dense vector."""
    valid = torch.arange(keys.shape[0], device=keys.device) < count
    safe = torch.where(valid, keys, 0).long()
    return values.new_zeros(size).index_add(0, safe,
                                            torch.where(valid, values, 0))
