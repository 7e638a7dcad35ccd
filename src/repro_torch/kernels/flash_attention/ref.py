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

D1's split mode, for a decode cache whose sequence is split over ranks (a
rank holds positions ``[offset, offset + S)`` of every row):
:func:`decode_split_max_ref` is each (row, head)'s max over the visible
positions of the shard (-inf where it holds none),
:func:`decode_split_partial_ref` the unnormalized ``acc = sum p v`` and
``l = sum p`` against the merged max ``m``, with ``p`` cast to the cache
dtype as one-device decode casts it, and :func:`decode_merge` the ranks'
partials summed in rank order and divided: one device's arithmetic, the
sums over shards in another order.
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


def _visible(kv_len, b: int, S: int, window: Optional[int],
             offset: int) -> Tuple[int, int]:
    """Row ``b``'s visible positions ``[max(0, n - window), n)`` (``n`` its
    length; the whole cache for ``kv_len`` None) as slots ``[lo, hi)`` of a
    shard holding positions ``offset .. offset + S - 1``."""
    if isinstance(kv_len, torch.Tensor):
        n = int(kv_len.reshape(-1)[b])
    else:
        n = S + offset if kv_len is None else int(kv_len)
    lo = max(0, n - window) if window is not None else 0
    return (min(max(lo - offset, 0), S), min(max(n - offset, 0), S))


def _ordered(q1, k_cache, v_cache, kv_len, window, offset: int = 0,
             m_in: Optional[torch.Tensor] = None):
    """D1's order (:func:`decode_attention_ordered`) over a shard of the
    cache: per row and head the max ``m`` of the visible scores (or
    ``m_in`` (B, Hq) where given), and the sums ``o = sum
    f32(cast_cache(p)) v`` and ``l = sum p``, each -inf / zeros where the
    shard holds no visible position.  Returns m (B, Hkv, g), o (B, Hkv, g,
    D) and l (B, Hkv, g), f32."""
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    g = Hq // Hkv
    cd, dev = k_cache.dtype, q1.device
    C, R, W = DECODE_CHUNK, DECODE_CTAS, DECODE_WARPS
    U = C // W
    qg = (q1.float() * torch.tensor(D ** -0.5, dtype=torch.float32)
          ).to(q1.dtype).to(cd).float().reshape(B, Hkv, g, D)
    ms = torch.full((B, Hkv, g), -torch.inf, device=dev)
    os_ = torch.zeros((B, Hkv, g, D), dtype=torch.float32, device=dev)
    ls = torch.zeros((B, Hkv, g), dtype=torch.float32, device=dev)
    for b in range(B):
        lo, hi = _visible(kv_len, b, S, window, offset)
        if hi <= lo:
            if m_in is not None:
                ms[b] = m_in[b].reshape(Hkv, g)
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
        if m_in is None:
            m = torch.where(valid, s, -torch.inf).amax(dim=(2, 3, 4, 5),
                                                       keepdim=True)
        else:
            m = m_in[b].reshape(Hkv, g, 1, 1, 1, 1)
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
        ms[b], os_[b], ls[b] = m.reshape(Hkv, g), o, l
    return ms, os_, ls


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
    _, o, l = _ordered(q1, k_cache, v_cache, kv_len, window)
    out = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, Hq, 1, D).to(q1.dtype)


# ------------------------------------------------- D1's split mode ----

def _split_scores(q1, k_cache, kv_len, window: Optional[int], offset: int):
    """(s (B, Hkv, g, 1, S) f32 scores of :func:`decode_attention_ref`,
    keep (.., S) bool: the shard's positions ``offset + j`` in each row's
    visible range)."""
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    qg = (q1 * D ** -0.5).to(k_cache.dtype).reshape(B, Hkv, Hq // Hkv, 1, D)
    s = torch.matmul(qg.float(), k_cache.float()[:, :, None].transpose(-1, -2))
    pos = offset + torch.arange(S, device=q1.device)
    n = (kv_len.reshape(-1, 1, 1, 1, 1) if isinstance(kv_len, torch.Tensor)
         else kv_len)
    keep = pos < n
    if window is not None:
        keep = keep & (pos >= n - window)
    return s, keep


def decode_split_max_ref(q1: torch.Tensor, k_cache: torch.Tensor, *,
                         kv_len, window: Optional[int] = None,
                         offset: int = 0) -> torch.Tensor:
    """D1's split mode (a): q1 (B, Hq, 1, D) against a shard (B, Hkv, S,
    D) of a cache that holds positions ``offset .. offset + S - 1`` of
    every row; ``kv_len`` (an int or a (B,) tensor) and ``window`` are the
    whole row's, as one-device decode takes them.  Returns (B, Hq) f32:
    each (row, head)'s largest score over the visible positions of the
    shard, -inf where it holds none."""
    B, Hq = q1.shape[:2]
    s, keep = _split_scores(q1, k_cache, kv_len, window, offset)
    return torch.where(keep, s, -torch.inf).amax(dim=-1).reshape(B, Hq)


def decode_split_partial_ref(q1: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, m: torch.Tensor, *,
                             kv_len, window: Optional[int] = None,
                             offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """D1's split mode (b): given ``m`` (B, Hq) f32, the max over every
    shard of the row, the shard's unnormalized ``acc = sum
    f32(cast_cache(p)) v`` (B, Hq, D) and ``l = sum p`` (B, Hq), f32, ``p
    = exp(s - m)`` over its visible positions (zeros where it holds
    none); shapes and arguments as :func:`decode_split_max_ref`."""
    B, Hq, _, D = q1.shape
    Hkv = k_cache.shape[1]
    s, keep = _split_scores(q1, k_cache, kv_len, window, offset)
    p = torch.where(keep, torch.exp(s - m.reshape(B, Hkv, -1, 1, 1)), 0.0)
    acc = torch.matmul(p.to(v_cache.dtype).float(),
                       v_cache.float()[:, :, None])
    return acc.reshape(B, Hq, D), p.sum(dim=-1).reshape(B, Hq)


def decode_split_max_ordered(q1, k_cache, *, kv_len,
                             window: Optional[int] = None,
                             offset: int = 0) -> torch.Tensor:
    """The kernel's split mode (a) in its order (:func:`_ordered` over the
    shard): (B, Hq) f32, the bits the kernel gives."""
    m, _, _ = _ordered(q1, k_cache, k_cache, kv_len, window, offset)
    return m.reshape(q1.shape[0], q1.shape[1])


def decode_split_partial_ordered(q1, k_cache, v_cache, m, *, kv_len,
                                 window: Optional[int] = None,
                                 offset: int = 0):
    """The kernel's split mode (b) in its order: (acc (B, Hq, D), l (B,
    Hq)), f32, the bits the kernel gives."""
    B, Hq, _, D = q1.shape
    _, o, l = _ordered(q1, k_cache, v_cache, kv_len, window, offset, m)
    return o.reshape(B, Hq, D), l.reshape(B, Hq)


def decode_merge(acc: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The ranks' partials of the split mode, ``acc`` (n, B, Hq, D) and
    ``l`` (n, B, Hq) in rank order, summed in that order and divided, as
    D1 finishes a row: ``out = acc / (l == 0 ? 1 : l)`` in f32, cast to
    ``dtype``.  Returns (B, Hq, 1, D)."""
    a, s = acc[0], l[0]
    for r in range(1, acc.shape[0]):
        a, s = a + acc[r], s + l[r]
    return (a / torch.where(s == 0, 1.0, s)[..., None]).unsqueeze(2).to(dtype)
