"""Top-k sparse gradient exchange built on the SU union op.

The port of ``repro/grad_comp/sparse_allreduce.py``.  Each worker
sparsifies its gradient to the top-k (index, value) stream
(``core.su.topk_sparsify``); combining two workers' streams is a
sorted-index union with add-combine (``core.su.union_add``, Occamy's SU
merge mode), so the all-reduce becomes a tree of unions over log2(W)
rounds that moves O(k log W) elements instead of O(D).  The dropped mass
stays in a local error-feedback buffer.

``sparse_allreduce_tree`` is the single-process form over stacked worker
gradients.  ``sparse_psum_shard_map`` is the collective form on a
``torch.distributed`` group: each rank contributes its compressed stream
through an all-gather of (keys, values), the only traffic, and takes the
union locally, in rank order, so every rank gets what
``sparse_allreduce_tree`` gives on the ranks' stacked gradients.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.formats import INVALID_KEY
from repro_torch.core.su import stream_densify, topk_sparsify, union_add


def compress(grad_flat: torch.Tensor, k: int,
             error: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k sparsify with error feedback.  Returns (keys, vals,
    new_error)."""
    if error is not None:
        grad_flat = grad_flat + error
    keys, vals = topk_sparsify(grad_flat, k)
    kept = stream_densify(keys, vals,
                          torch.tensor(k, device=grad_flat.device),
                          grad_flat.shape[0])
    return keys, vals, grad_flat - kept


def union_reduce(keys_stack: torch.Tensor, vals_stack: torch.Tensor):
    """Union-combine W workers' sorted streams (a tree of unions).
    keys_stack: (W, k) int32; vals_stack: (W, k).  Returns one (keys,
    vals, count) stream of capacity W * k."""
    streams = [(keys_stack[i], vals_stack[i])
               for i in range(keys_stack.shape[0])]
    while len(streams) > 1:
        nxt = []
        for i in range(0, len(streams) - 1, 2):
            (ak, av), (bk, bv) = streams[i], streams[i + 1]
            u = union_add(ak, av, bk, bv)
            nxt.append((u.keys, u.values))
        if len(streams) % 2:
            lk, lv = streams[-1]
            pad = lk.shape[0]
            nxt.append((F.pad(lk, (0, pad), value=int(INVALID_KEY)),
                        F.pad(lv, (0, pad))))
        streams = nxt
    keys, vals = streams[0]
    count = (keys != int(INVALID_KEY)).sum().to(torch.int32)
    return keys, vals, count


def sparse_allreduce_tree(grads_stack: torch.Tensor, k: int):
    """Dense (W, D) worker gradients -> the mean gradient through the sparse
    union.  Returns (dense mean (D,), per-worker error feedback (W, D))."""
    W, D = grads_stack.shape
    parts = [compress(g, k) for g in grads_stack]
    keys = torch.stack([p[0] for p in parts])
    vals = torch.stack([p[1] for p in parts])
    errs = torch.stack([p[2] for p in parts])
    ukeys, uvals, count = union_reduce(keys, vals)
    return stream_densify(ukeys, uvals, count, D) / W, errs


def sparse_psum_shard_map(grad_local: torch.Tensor, k: int, group
                          ) -> torch.Tensor:
    """The mean of the ranks' gradients through the sparse union, on every
    rank of ``group`` (a process group, or a ``(mesh, dim name)`` pair):
    ``grad_local`` (D,) is this rank's gradient.  Compress it, all-gather
    every rank's (keys, values), union them in rank order, densify, divide
    by the rank count."""
    if isinstance(group, tuple):
        mesh, dim = group
        group = mesh.get_group(dim)
    W = dist.get_world_size(group)
    keys, vals, _ = compress(grad_local, k)
    all_keys = [torch.empty_like(keys) for _ in range(W)]
    all_vals = [torch.empty_like(vals) for _ in range(W)]
    dist.all_gather(all_keys, keys, group=group)    # the only traffic
    dist.all_gather(all_vals, vals, group=group)
    ukeys, uvals, count = union_reduce(torch.stack(all_keys),
                                       torch.stack(all_vals))
    return stream_densify(ukeys, uvals, count, grad_local.shape[0]) / W


def compression_ratio(D: int, k: int, workers: int) -> float:
    """Bytes moved against a dense ring all-reduce (2 x D a worker)."""
    dense = 2 * D * 4
    sparse = workers * k * 8   # int32 index + f32 value gathered
    return dense / sparse
