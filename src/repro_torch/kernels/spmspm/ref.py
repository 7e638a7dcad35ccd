"""Plain PyTorch versions of SpMSpM over padded-ELL streams (K5).

* :func:`spmspm_ell_ref` -- the kernel's contract: C[r, c] accumulates
  ``a * b`` over the keys A's row r and B's column c share, one step of A's
  ``la`` stream at a time (ascending keys), only on a match, product then
  sum each rounded in f32; narrow A values dequantize as ``q.float() *
  scale`` first.  The CUDA kernel computes the same sums in the same order,
  so the two agree bit for bit.  Keys are unique within a stream, as
  :func:`..ops.dense_to_ell_rows` makes them.
* :func:`spmspm_ref` -- the oracle: densify both streams and matmul.
* :func:`spmspm_gather_baseline` -- the no-SU baseline: the all-pairs
  compare as plain tensor ops (R * C * La * Lb booleans: small inputs only).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.formats import INVALID_KEY

_INVALID = int(INVALID_KEY)


def ell_to_dense(keys: torch.Tensor, vals: torch.Tensor,
                 width: int) -> torch.Tensor:
    """(R, L) padded-ELL streams -> dense f32 (R, width)."""
    mask = keys != _INVALID
    rows = torch.arange(keys.shape[0], device=keys.device)[:, None].expand(
        keys.shape)
    out = torch.zeros((keys.shape[0], width), dtype=torch.float32,
                      device=keys.device)
    out.index_put_((rows[mask], keys[mask].long()), vals[mask].float(),
                   accumulate=True)
    return out


def spmspm_ref(a_keys, a_vals, b_keys, b_vals, inner: int) -> torch.Tensor:
    """Oracle: densify both streams over ``inner`` keys and matmul (A rows
    x B columns) in f32."""
    return ell_to_dense(a_keys, a_vals, inner) @ \
        ell_to_dense(b_keys, b_vals, inner).T


def spmspm_gather_baseline(a_keys, a_vals, b_keys, b_vals) -> torch.Tensor:
    """No-SU baseline: the all-pairs compare as generic tensor ops."""
    ak = a_keys[:, None, :, None]
    bk = b_keys[None, :, None, :]
    av = a_vals[:, None, :, None].float()
    bv = b_vals[None, :, None, :].float()
    eq = (ak == bk) & (ak != _INVALID)
    return torch.where(eq, av * bv, 0.0).sum(dim=(2, 3))


def spmspm_ell_ref(a_keys: torch.Tensor, a_vals: torch.Tensor,
                   b_keys: torch.Tensor, b_vals: torch.Tensor, *,
                   a_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C (R, C) f32 with the kernel's sums: for each step p of A's stream,
    every row's key ``a_keys[:, p]`` is looked up in every B column
    (``searchsorted``) and, where it is found, ``a * b`` is added."""
    R, La = a_keys.shape
    C = b_keys.shape[0]
    av = a_vals.float()
    if a_scales is not None:
        av = av * a_scales.reshape(R, 1).float()
    bv = b_vals.float()
    acc = torch.zeros((C, R), dtype=torch.float32, device=a_keys.device)
    valid = a_keys != _INVALID
    steps = int(valid.sum(dim=1).max()) if R else 0
    for p in range(steps):
        key = a_keys[:, p].contiguous()
        loc = torch.searchsorted(b_keys, key.expand(C, R).contiguous())
        loc = loc.clamp(max=b_keys.shape[1] - 1)
        hit = (b_keys.gather(1, loc) == key) & valid[:, p]
        prod = av[:, p] * bv.gather(1, loc)
        acc = torch.where(hit, acc + prod, acc)
    return acc.T.contiguous()
