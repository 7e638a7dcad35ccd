"""Plain PyTorch versions of the flash-attention kernels (K3, K4m, K4s), of
the one-token decode attention D1, and the materialized oracle.

``attention_ref`` is the reference's oracle: full f32 scores, softmax, rows
with no visible key give zero.  The three ``*_ref`` functions compute what
the CUDA kernels compute, as the same tile loop: one q-tile row at a time
for every (batch, head) together, the row's KV tiles taken in column order,
each through the one shared :func:`_tile_update` (f32 scores, an online
softmax in f32, ``p`` kept in f32 for the PV product) and finished by
:func:`_finalize`.  Because all three share the update and the order, the
sparse walk equals the masked grid, and the sparse walk on a plain causal
or window mask equals K3, as ``torch.equal`` -- on the CPU as on the card.
The wrappers in ``kernel.py`` take these for CPU tensors, and
``chip_smoke.py`` holds each kernel against its plain version on the card.

``decode_attention_ref`` is the reference's ``decode_attention``
(repro/kernels/flash_attention/ops.py:212) in PyTorch: batched f32
products, which on the card may sum in an order that depends on the batch
count; the kernel D1 fixes one order per row.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.masks import KIND_CAUSAL, KIND_WINDOW, NEG_INF

_State = List[torch.Tensor]       # [m (.., bq, 1), l (.., bq, 1), acc (.., bq, D)]


def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, scale: Optional[float] = None,
                  mask=None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  Full-score reference.

    ``mask``: a ``core.masks.BlockMask`` (its ``dense_mask()`` oracle is
    used, overriding ``causal``/``window``) or a dense boolean (Sq, Skv)
    array or tensor."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    g = Hq // k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        dense = mask.dense_mask() if hasattr(mask, "dense_mask") else mask
        vis = torch.as_tensor(np.asarray(dense, bool), device=q.device)
    else:
        q_pos = torch.arange(Sq, device=q.device)[:, None]
        k_pos = torch.arange(Skv, device=q.device)[None, :]
        vis = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            vis = vis & (q_pos >= k_pos)
        if window is not None:
            vis = vis & ((q_pos - k_pos) < window)
    s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.float())
    out = torch.where(vis.any(dim=-1)[:, None], out, 0.0)
    return out.to(q.dtype)


# --------------------------------------------------------- the tile loop ----

def _init(q: torch.Tensor, bq: int) -> _State:
    B, Hq, _, D = q.shape
    dev = q.device
    return [torch.full((B, Hq, bq, 1), NEG_INF, device=dev),
            torch.zeros((B, Hq, bq, 1), device=dev),
            torch.zeros((B, Hq, bq, D), device=dev)]


def _q_tile(q: torch.Tensor, qi: int, bq: int, scale: float) -> torch.Tensor:
    """Q tile ``qi`` of every (batch, head), f32, scaled."""
    return q[:, :, qi * bq:(qi + 1) * bq].float() * scale


def _tile_update(st: _State, qf: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, *, kind: int, q0: int, k0: int,
                 window: Optional[int], skv: int) -> None:
    """One online-softmax update of the row state ``st`` with the KV tile
    starting at key ``k0``; ``q0`` is the absolute position of the tile's
    first query.  ``qf`` (B, Hq, bq, D) f32 scaled; ``k``/``v`` the
    (B, Hkv, bk, D) tile in its own dtype (GQA: query head h reads KV head
    h // g).  The kind bits refine the tile (causal edge, window edge) and
    ``skv`` masks the KV tail.  With ``p = where(mask, exp(s - m_new), 0)``
    a fully masked tile is an exact no-op (alpha = 1, p = 0)."""
    B, Hq, bq, D = qf.shape
    Hkv, bk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    m, l, acc = st
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    s = torch.matmul(qf.reshape(B, Hkv, g, bq, D), kf.transpose(-1, -2))
    s = s.reshape(B, Hq, bq, bk)
    dev = qf.device
    q_pos = q0 + torch.arange(bq, device=dev)[:, None]
    k_pos = k0 + torch.arange(bk, device=dev)[None, :]
    mask = k_pos < skv
    if kind & KIND_CAUSAL:
        mask = mask & (q_pos >= k_pos)
    if window is not None and kind & KIND_WINDOW:
        mask = mask & ((q_pos - k_pos) < window)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(mask, torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    pv = torch.matmul(p.reshape(B, Hkv, g, bq, bk), vf).reshape(B, Hq, bq, D)
    st[0] = m_new
    st[1] = l * alpha + p.sum(dim=-1, keepdim=True)
    st[2] = acc * alpha + pv


def _finalize(st: _State, dtype: torch.dtype) -> torch.Tensor:
    """acc / l, a row that saw no key giving 0, in the output dtype."""
    l = st[1]
    return (st[2] / torch.where(l == 0, 1.0, l)).to(dtype)


def _kv_tile(t: torch.Tensor, c: int, bk: int) -> torch.Tensor:
    return t[:, :, c * bk:(c + 1) * bk]


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return scale if scale is not None else q.shape[-1] ** -0.5


# ------------------------------------------------------- the three kernels --

def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None, bq: int = 128,
                        bk: int = 128, q_offset: int = 0,
                        skv: Optional[int] = None) -> torch.Tensor:
    """K3: causal / window attention over every KV tile in column order,
    skipping a tile none of whose (q, k) pairs can be visible (the interval
    test of ``BlockMask._bbox_visible``).  q (B, Hq, Sq, D), k/v (B, Hkv,
    Skv, D) with Sq % bq == 0 and Skv % bk == 0 (``ops`` pads);
    ``q_offset`` is the absolute position of q row 0; ``skv`` the true KV
    length (default Skv), keys at or past it are masked."""
    Sq, Skv = q.shape[2], k.shape[2]
    skv = Skv if skv is None else skv
    bq, bk = min(bq, Sq), min(bk, Skv)
    assert Sq % bq == 0 and Skv % bk == 0, (Sq, bq, Skv, bk)
    scale = _scale(q, scale)
    kind = (KIND_CAUSAL if causal else 0) | (
        KIND_WINDOW if window is not None else 0)
    out = torch.empty_like(q)
    for qi in range(Sq // bq):
        q_lo = q_offset + qi * bq
        q_hi = q_lo + bq - 1
        st, qf = _init(q, bq), _q_tile(q, qi, bq, scale)
        for ki in range(Skv // bk):
            k_lo = ki * bk
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_lo + bk - 1 < q_lo - window + 1:
                continue
            _tile_update(st, qf, _kv_tile(k, ki, bk), _kv_tile(v, ki, bk),
                         kind=kind, q0=q_lo, k0=k_lo, window=window, skv=skv)
        out[:, :, qi * bq:(qi + 1) * bq] = _finalize(st, q.dtype)
    return out


def flash_attention_masked_ref(q, k, v, tile_kinds, *, skv: int,
                               window: Optional[int] = None,
                               scale: Optional[float] = None,
                               q_offset: int = 0) -> torch.Tensor:
    """K4m: the full (n_q, n_kv) tile grid gated by a per-tile kind map
    (``BlockMask.tile_kinds``; kind < 0 skips the tile).  q (B, Hq, Sq_pad,
    D), k/v (B, Hkv, Skv_pad, D), tiles (Sq_pad // n_q, Skv_pad // n_kv);
    ``skv`` is the true KV length."""
    kinds = np.asarray(torch.as_tensor(tile_kinds).cpu(), np.int64)
    n_q, n_kv = kinds.shape
    bq, bk = q.shape[2] // n_q, k.shape[2] // n_kv
    scale = _scale(q, scale)
    out = torch.empty_like(q)
    for qi in range(n_q):
        st, qf = _init(q, bq), _q_tile(q, qi, bq, scale)
        for ki in range(n_kv):
            if kinds[qi, ki] >= 0:
                _tile_update(st, qf, _kv_tile(k, ki, bk), _kv_tile(v, ki, bk),
                             kind=int(kinds[qi, ki]), q0=q_offset + qi * bq,
                             k0=ki * bk, window=window, skv=skv)
        out[:, :, qi * bq:(qi + 1) * bq] = _finalize(st, q.dtype)
    return out


def _row_slices(rows: np.ndarray) -> List[Tuple[int, int, int]]:
    """(row, start, end) of each run of equal entries in the sorted rows."""
    if rows.size == 0:
        return []
    cuts = np.flatnonzero(np.diff(rows)) + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [rows.size]])
    return [(int(rows[s]), int(s), int(e)) for s, e in zip(starts, ends)]


def flash_attention_sparse_ref(q, k, v, rows, cols, kinds, *, skv: int,
                               window: Optional[int] = None,
                               scale: Optional[float] = None, bq: int = 128,
                               bk: int = 128, q_offset: int = 0
                               ) -> torch.Tensor:
    """K4s: walk the sorted (row, col, kind) stream of ``BlockMask.lower()``.
    Each q-tile row takes its slice of the stream in order; kind < 0
    (bucket pads, empty-row markers) skips the entry, and a row absent from
    the stream gives zeros.  Shapes as :func:`flash_attention_masked_ref`."""
    rows, cols, kinds = (np.asarray(torch.as_tensor(t).cpu(), np.int64)
                         for t in (rows, cols, kinds))
    scale = _scale(q, scale)
    out = torch.zeros_like(q)
    for r, start, end in _row_slices(rows):
        st, qf = _init(q, bq), _q_tile(q, r, bq, scale)
        for i in range(start, end):
            if kinds[i] >= 0:
                c = int(cols[i])
                _tile_update(st, qf, _kv_tile(k, c, bk), _kv_tile(v, c, bk),
                             kind=int(kinds[i]), q0=q_offset + r * bq,
                             k0=c * bk, window=window, skv=skv)
        out[:, :, r * bq:(r + 1) * bq] = _finalize(st, q.dtype)
    return out


# ------------------------------------------------------- decode (D1) ----

def decode_attention_ref(q1: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, *, kv_len=None,
                         window: Optional[int] = None) -> torch.Tensor:
    """One-token decode: q1 (B, Hq, 1, D) against a (B, Hkv, S, D) cache.
    ``kv_len``: None (the whole cache), an int, or a ``(B,)`` int tensor of
    per-row lengths, which moves the window's lower edge per row too.  The
    arithmetic of ``ops.decode_attention``: scores and sums in f32, the
    unnormalized ``exp(s - m)`` cast to the cache dtype for the PV product,
    then divided by the f32 row sum.  A row with no visible position gives
    the mean of V (``NEG_INF`` is finite)."""
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    g = Hq // Hkv
    scale = D ** -0.5
    qg = (q1 * scale).to(k_cache.dtype).reshape(B, Hkv, g, 1, D)
    s = torch.matmul(qg.float(), k_cache.float()[:, :, None].transpose(-1, -2))
    pos = torch.arange(S, device=q1.device)
    if kv_len is not None:
        if isinstance(kv_len, torch.Tensor):
            kv_len = kv_len.reshape(-1, 1, 1, 1, 1)
        keep = pos < kv_len
        if window is not None:
            keep = keep & (pos >= kv_len - window)
        s = s.masked_fill(~keep, NEG_INF)
    elif window is not None:
        s = s.masked_fill(pos < S - window, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)                      # unnormalized, like prefill
    l = p.sum(dim=-1, keepdim=True)           # f32 row sum
    out = torch.matmul(p.to(v_cache.dtype).float(), v_cache.float()[:, :, None])
    out = out / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, 1, D).to(q1.dtype)


# D1's order constants (``csrc/decode_attention.cu``): chunks of
# DECODE_CHUNK positions counted from a row's lo, chunk c to CTA c mod
# DECODE_CTAS of the row's cluster, position i of a chunk to warp i mod
# DECODE_WARPS; a CTA holds its scores in DECODE_SCORE_BYTES of shared
# memory, else pass 2 recomputes them.
DECODE_CHUNK = 32
DECODE_CTAS = 8
DECODE_WARPS = 8
DECODE_SCORE_BYTES = 32768
# A GQA group of more heads is taken in passes of at most DECODE_PASS_HEADS
# heads, each a cluster of its own that reads the row's K and V once; a
# head's order is the same in any pass, so the emulation has no passes.
DECODE_PASS_HEADS = 8


def _lane_sum(part: torch.Tensor) -> torch.Tensor:
    """The kernel's xor-butterfly over the last dim (32 lanes)."""
    lanes = torch.arange(32, device=part.device)
    for o in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ o]
    return part[..., 0]


def _decode_scores(qg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """D1's scores of qg (Hkv, g, D) against k (Hkv, *P, D): lane ``l`` of
    32 sums its ``E = D / 32`` dims (one dim on lanes < 16 at D 16) in
    index order, then the xor-butterfly.  Returns (Hkv, g, *P)."""
    Hkv, g, D = qg.shape
    lanes = 32 if D >= 32 else D
    E = D // lanes
    P = k.shape[1:-1]
    prod = qg.reshape(Hkv, g, *(1,) * len(P), D) * k[:, None]
    prod = prod.reshape(*prod.shape[:-1], lanes, E)
    part = prod[..., 0]
    for e in range(1, E):
        part = part + prod[..., e]
    return _lane_sum(torch.nn.functional.pad(part, (0, 32 - lanes)))


def decode_attention_ordered(q1: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, *, kv_len=None,
                             window: Optional[int] = None) -> torch.Tensor:
    """D1's order of operations in PyTorch, one batch row at a time (its kv
    heads together), each product and sum rounded to f32 as the kernel
    rounds it:

    * ``qg = cast_cache(cast_q(q * D^-0.5))``; a score as
      :func:`_decode_scores`;
    * the visible positions ``[lo, hi)`` cut into chunks of
      :data:`DECODE_CHUNK` from ``lo``; chunk ``c`` to CTA ``c mod``
      :data:`DECODE_CTAS`, which takes its chunks in order; position ``i``
      of a chunk to warp ``i mod`` :data:`DECODE_WARPS` of that CTA: warp
      ``(r, w)``'s ``u``-th position of its CTA's ``t``-th chunk is ``lo +
      (r + 8 t) 32 + w + 8 u``;
    * ``m``: the max over the visible positions;
    * each warp sums ``p = exp(s - m)`` and ``f32(cast_cache(p)) * v`` from
      zero over its positions in (t, u) order; a CTA adds its warps' sums
      in warp order, the row its CTAs' sums in rank order; ``out = sum /
      (l == 0 ? 1 : l)``, cast to q's dtype.

    Where a CTA's scores exceed :data:`DECODE_SCORE_BYTES` the kernel's
    pass 2 recomputes them from K by the same tree, so the same bits: one
    emulation covers both.  Nothing here reads another
    row, or the cache past ``hi``, so a row's bits do not depend on B or on
    the cache's capacity.  A row with no visible position gives zeros, as
    the kernel does."""
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    g = Hq // Hkv
    cd, dev = k_cache.dtype, q1.device
    C, R, W = DECODE_CHUNK, DECODE_CTAS, DECODE_WARPS
    U = C // W
    qg = (q1.float() * torch.tensor(D ** -0.5, dtype=torch.float32)
          ).to(q1.dtype).to(cd).float().reshape(B, Hkv, g, D)
    out = torch.zeros((B, Hkv, g, D), dtype=torch.float32, device=dev)
    for b in range(B):
        if isinstance(kv_len, torch.Tensor):
            n = int(kv_len.reshape(-1)[b])
        else:
            n = S if kv_len is None else int(kv_len)
        hi = min(n, S)
        lo = max(0, n - window) if window is not None else 0
        if hi <= lo:
            continue
        T = -(-(hi - lo) // (C * R))          # chunks of the busiest CTA
        ar = lambda n, at: torch.arange(n, device=dev).reshape(  # noqa: E731
            [n if i == at else 1 for i in range(4)])
        pos = lo + (ar(R, 2) + R * ar(T, 0)) * C + ar(W, 3) + W * ar(U, 1)
        valid = pos < hi                                    # (T, U, R, W)
        pos = pos.clamp(max=hi - 1)
        k = k_cache[b][:, pos].float()                      # (Hkv, T, U, R, W, D)
        v = v_cache[b][:, pos].float()
        s = _decode_scores(qg[b], k)                        # (Hkv, g, T, U, R, W)
        m = torch.where(valid, s, -torch.inf).amax(dim=(2, 3, 4, 5),
                                                   keepdim=True)
        p = torch.where(valid, torch.exp(s - m), 0.0)
        pn = p.to(cd).float()
        l_w = torch.zeros((Hkv, g, R, W), device=dev)
        acc = torch.zeros((Hkv, g, R, W, D), device=dev)
        for t in range(T):
            for u in range(U):
                l_w = l_w + p[:, :, t, u]
                acc = acc + torch.where(valid[t, u, :, :, None],
                                        pn[:, :, t, u, :, :, None]
                                        * v[:, None, t, u], 0.0)
        l_c, o_c = l_w[..., 0], acc[..., 0, :]               # warp order
        for w in range(1, W):
            l_c, o_c = l_c + l_w[..., w], o_c + acc[..., w, :]
        l, o = l_c[..., 0], o_c[..., 0, :]                   # rank order
        for r in range(1, R):
            l, o = l + l_c[..., r], o + o_c[..., r, :]
        out[b] = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, Hq, 1, D).to(q1.dtype)
