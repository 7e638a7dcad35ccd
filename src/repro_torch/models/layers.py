"""Neural-net layer primitives: norms, RoPE, GQA attention, MLPs.

Pure functions on tensors with parameter dicts, as in the reference.
Prefill attention is ``impl="chunked"`` (online softmax over KV chunks, the
default), ``"kernel"`` (the flash kernel K3) or ``"ref"`` (the materialized
oracle); an ``attn_mask`` (``AttnMaskSpec``) sends prefill through the masked
flash kernels (K4s / K4m).  Decode is ``decode_attention`` at a scalar
cache position or at per-row positions (continuous batching); a quantized
cache (``kv_quant``: narrow K/V with per-position f32 scales) is
dequantized whole before it.  A local layer's cache of exactly ``window``
slots is a ring buffer (position ``p`` at slot ``p % window``).
``impl="kernel_sharded"`` is the train path's kernel: K3 on the forward,
split over the context's mesh when one is set
(:func:`sharded_flash_attention`), the chunked VJP on the backward
(:class:`FlashFwdChunkedBwd`);
on the card the chunked path's narrow products carry their backward in
:class:`ChunkedAttention`.

Under ``parallel.context.ACT_SPEC`` (the sharded train step and the
serving steps on a mesh) the weights are this rank's "model" share:
attention takes its head counts from ``wq`` / ``wk`` and runs on the
rank's heads, the MLP on its ``d_ff`` slice; the normed stream goes
through ``parallel.collectives.enter`` before the column-parallel
products and ``leave`` after the row-parallel ``wo`` / ``w_down``
(sequence parallel: all-gather / reduce-scatter over "model"; without:
identity / all-reduce).  The decode cache there holds every head over the
rank's part of the sequence (``cache_axis``: the mesh axis that splits
it): prefill hands its heads' K / V over by one all-to-all, and decode
gathers q, k and v over "model" and runs D1's split mode on its part
(:func:`split_decode_attention`).  Unset, nothing of it runs.

Matmuls take operands in the compute dtype: a bf16 x bf16 product gives a
bf16 result accumulated in f32 (reduced-precision reductions are off, see
``repro_torch.set_numerics``).  Where the reference asks for an f32 result
of narrow operands (``preferred_element_type``), the operands are widened to
f32 first: the products are exact and the sum is f32.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import precision
from repro_torch.core.masks import NEG_INF, AttnMaskSpec
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.router import ops as router_ops
from repro_torch.models.config import ArchConfig
from repro_torch.parallel import collectives as tp
from repro_torch.parallel.sharding import TP


# ------------------------------------------------------------------ init ----

# the largest f32 temporary of one draw of :func:`normal`: a repeat slice
# past it (llama4-maverick's 128 stacked experts, 21.5 GB in f32) is drawn
# in pieces along its first dim; every smaller slice is one draw
DRAW_BYTES = 6 * 2**30


def normal(g: torch.Generator, shape, scale: float, *, n: int, dtype,
           device) -> torch.Tensor:
    """(n,) + shape stacked N(0, 1) * scale weights, drawn per repeat slice
    in f32 then stored in ``dtype`` (no full-stack f32 temporary; a slice
    of more than :data:`DRAW_BYTES` in f32 drawn in pieces of at most
    that along its first dim)."""
    out = torch.empty((n,) + tuple(shape), dtype=dtype, device=device)
    row = 4 * math.prod(shape[1:])
    step = max(1, DRAW_BYTES // row)
    for i in range(n):
        for j in range(0, shape[0], step):
            piece = (min(step, shape[0] - j),) + tuple(shape[1:])
            out[i, j:j + step] = torch.randn(piece, generator=g,
                                             device=device) * scale
    return out


def init_rmsnorm(d: int, *, n: int, device):
    return {"scale": torch.ones((n, d), dtype=torch.float32, device=device)}


def init_attention(g, cfg: ArchConfig, *, n: int, dtype, device):
    d, hd, Hq, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    kw = dict(n=n, dtype=dtype, device=device)
    p = {"wq": normal(g, (d, Hq * hd), s, **kw),
         "wk": normal(g, (d, Hkv * hd), s, **kw),
         "wv": normal(g, (d, Hkv * hd), s, **kw),
         "wo": normal(g, (Hq * hd, d), s, **kw)}
    if cfg.qkv_bias:
        for name, width in (("bq", Hq), ("bk", Hkv), ("bv", Hkv)):
            p[name] = torch.zeros((n, width * hd), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, n=n, device=device)
        p["k_norm"] = init_rmsnorm(hd, n=n, device=device)
    return p


def init_mlp(g, cfg: ArchConfig, *, n: int, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    kw = dict(n=n, dtype=dtype, device=device)
    if cfg.mlp_type == "swiglu":
        return {"w_gate": normal(g, (d, ff), d ** -0.5, **kw),
                "w_up": normal(g, (d, ff), d ** -0.5, **kw),
                "w_down": normal(g, (ff, d), ff ** -0.5, **kw)}
    return {"w_up": normal(g, (d, ff), d ** -0.5, **kw),
            "w_down": normal(g, (ff, d), ff ** -0.5, **kw)}


# ----------------------------------------------------------------- norms ----

def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6, *,
            row_order: bool = False) -> torch.Tensor:
    """RMS norm over the last axis.  ``row_order`` (the decode step's
    norms): the sum of squares comes from ``router.ops.row_sum``, one
    summation order a row on the card (R1), so a row normalizes to the
    same bits in any batch; the library's mean lays its reduction's threads
    out by the number of rows, so its bits depend on the batch.  On the CPU
    the sum over d is the mean's own arithmetic, bit for bit."""
    x32 = x.float()
    sq = x32 * x32
    if row_order:
        var = router_ops.row_sum(sq) / x.shape[-1]
    else:
        var = sq.mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope ----

def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,) or broadcastable."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention ----

def _qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor,
         row_order: bool = False):
    """q, k, v (B, H, S, hd) after qk_norm and RoPE; ``row_order`` (decode)
    sums qk_norm's squares in one order a row (:func:`rmsnorm`)."""
    B, S, _ = x.shape
    # the head counts of the weights given: the config's, or this rank's
    # share of them under tensor parallelism
    hd = cfg.hd
    Hq, Hkv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    cd = x.dtype
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(B, S, Hq, hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps, row_order=row_order)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps, row_order=row_order)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _narrow_operands(k: torch.Tensor) -> bool:
    """Whether :func:`chunked_attention` multiplies ``k``'s dtype as it is:
    bf16 / f16 on a CUDA device (whose ``torch.bmm`` takes ``out_dtype``)."""
    return k.device.type == "cuda" and k.dtype in (torch.bfloat16,
                                                   torch.float16)


# the KV chunk of the chunked path (the reference's default)
CHUNK = 1024
# prefill attention implementations (``apply_attention(impl=)``)
IMPLS = ("chunked", "kernel", "kernel_sharded", "ref")


def _chunk_mask(ci: int, chunk: int, Sq: int, Skv: int, causal: bool,
                window: Optional[int], dev) -> torch.Tensor:
    """(Sq, chunk) bool: the keys of KV chunk ``ci`` that each query
    sees."""
    q_pos = torch.arange(Sq, device=dev)[:, None]
    k_pos = ci * chunk + torch.arange(chunk, device=dev)[None, :]
    mask = k_pos < Skv
    if causal:
        mask = mask & (q_pos >= k_pos)
    if window is not None:
        mask = mask & ((q_pos - k_pos) < window)
    return mask


class _Chunks:
    """The operands of :func:`chunked_attention`'s loop: K and V padded to
    whole chunks, q scaled and cast to K's dtype with the GQA group on its
    head dim, and the score product of chunk ``ci`` (:meth:`scores`), on
    the narrow operands where ``narrow``, else widened to f32."""

    def __init__(self, q, k, v, chunk: int):
        B, Hq, Sq, hd = q.shape
        _, Hkv, Skv, _ = k.shape
        self.B, self.Hq, self.Sq, self.hd = B, Hq, Sq, hd
        self.Hkv, self.Skv, self.g = Hkv, Skv, Hq // Hkv
        self.scale = hd ** -0.5
        self.chunk = chunk = min(chunk, Skv)
        pad = (-Skv) % chunk
        if pad:
            k = F.pad(k, (0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, pad))
        self.k, self.v = k, v
        self.n_chunks = (Skv + pad) // chunk
        self.narrow = _narrow_operands(k)
        qg = (q * self.scale).to(k.dtype).reshape(B, Hkv, self.g, Sq, hd)
        self.qg = (qg.reshape(B * Hkv, self.g * Sq, hd) if self.narrow
                   else qg.float())

    def kv(self, ci: int):
        sl = slice(ci * self.chunk, (ci + 1) * self.chunk)
        return self.k[:, :, sl], self.v[:, :, sl]

    def scores(self, kb) -> torch.Tensor:
        """(B, Hkv, g, Sq, chunk) f32 scores of one KV chunk."""
        B, Hkv, hd = self.B, self.Hkv, self.hd
        if self.narrow:
            return torch.bmm(
                self.qg, kb.reshape(B * Hkv, self.chunk, hd).transpose(1, 2),
                out_dtype=torch.float32).view(B, Hkv, self.g, self.Sq,
                                              self.chunk)
        return torch.matmul(self.qg, kb[:, :, None].float().transpose(-1, -2))

    def mask(self, ci: int, causal: bool, window: Optional[int]):
        return _chunk_mask(ci, self.chunk, self.Sq, self.Skv, causal, window,
                           self.qg.device)


def _chunked_loop(q, k, v, causal: bool, window: Optional[int],
                  chunk: int):
    """The online softmax over KV chunks: (the f32 output (B, Hkv, g, Sq,
    hd), the row max m and the row sum l (B, Hkv, g, Sq, 1), f32)."""
    c = _Chunks(q, k, v, chunk)
    B, Hkv, g, Sq, hd = c.B, c.Hkv, c.g, c.Sq, c.hd
    dev = q.device
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, hd), device=dev)
    for ci in range(c.n_chunks):
        kb, vb = c.kv(ci)
        s = torch.where(c.mask(ci, causal, window), c.scores(kb), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if c.narrow:
            pv = torch.bmm(p.to(v.dtype).reshape(B * Hkv, g * Sq, c.chunk),
                           vb.reshape(B * Hkv, c.chunk, hd),
                           out_dtype=torch.float32).view(B, Hkv, g, Sq, hd)
        else:
            pv = torch.matmul(p.to(v.dtype).float(), vb[:, :, None].float())
        acc = acc * alpha + pv
        m = m_new
    return acc / torch.where(l == 0, 1.0, l), m, l


def _chunked_vjp(q, k, v, g_out, out, m, l, causal: bool,
                 window: Optional[int], chunk: int):
    """(dq, dk, dv) of :func:`chunked_attention` at (q, k, v) for the
    output gradient ``g_out``, given the loop's f32 output, row max and
    row sum: each KV chunk's scores recomputed (as the forward makes
    them), the probabilities ``exp(s - m) / l``, and the products of the
    gradient with the operands widened to f32 (the reference's VJP of its
    f32-output products); sums in f32, gradients in the inputs' dtypes."""
    c = _Chunks(q, k, v, chunk)
    B, Hkv, g, Sq, hd, T = c.B, c.Hkv, c.g, c.Sq, c.hd, c.chunk
    rows = (B * Hkv, g * Sq)
    do = g_out.float().reshape(B, Hkv, g, Sq, hd)
    delta = (do * out).sum(dim=-1, keepdim=True).reshape(*rows, 1)
    inv_l = torch.where(l == 0, 0.0, 1.0 / torch.where(l == 0, 1.0, l))
    do = do.reshape(*rows, hd)
    qg = c.qg.float().reshape(*rows, hd)
    dqg = torch.zeros((*rows, hd), device=q.device)
    dk = torch.zeros(c.k.shape, device=q.device)
    dv = torch.zeros(c.v.shape, device=q.device)
    for ci in range(c.n_chunks):
        kb, vb = c.kv(ci)
        s = torch.where(c.mask(ci, causal, window), c.scores(kb), NEG_INF)
        p = (torch.exp(s - m) * inv_l).reshape(*rows, T)
        kb = kb.float().reshape(B * Hkv, T, hd)
        vb = vb.float().reshape(B * Hkv, T, hd)
        sl = slice(ci * T, (ci + 1) * T)
        dv[:, :, sl] = torch.bmm(p.transpose(1, 2), do).view(B, Hkv, T, hd)
        ds = p * (torch.bmm(do, vb.transpose(1, 2)) - delta)
        dqg += torch.bmm(ds, kb)
        dk[:, :, sl] = torch.bmm(ds.transpose(1, 2), qg).view(B, Hkv, T, hd)
    dq = (dqg * c.scale).reshape(B, c.Hq, Sq, hd).to(q.dtype)
    return (dq, dk[:, :, :c.Skv].to(k.dtype),
            dv[:, :, :c.Skv].to(v.dtype))


class ChunkedAttention(torch.autograd.Function):
    """:func:`chunked_attention` on narrow operands with a backward: the
    forward is the loop (``torch.bmm`` with ``out_dtype``, which has no
    derivative), the backward :func:`_chunked_vjp`, which recomputes each
    KV chunk as the reference's per-chunk ``jax.checkpoint(body)`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        out, m, l = _chunked_loop(q, k, v, causal, window, chunk)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (causal, window, chunk)
        return out.reshape(q.shape).to(q.dtype)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, out, m, l = ctx.saved_tensors
        return _chunked_vjp(q, k, v, g_out, out, m, l, *ctx.args) + (
            None,) * 3


def chunked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None, chunk: int = CHUNK):
    """Online softmax over KV chunks.  q: (B, Hq, Sq, hd); k/v: (B, Hkv,
    Skv, hd).  Operands stay in their narrow dtype, products and sums are
    f32, and the GQA group rides along q's head dim (no K/V repeat).

    On a CUDA device with bf16 / f16 k and v both products run on the
    narrow operands with f32 outputs (``torch.bmm(..., out_dtype=float32)``,
    as the reference's ``preferred_element_type``), inside
    :class:`ChunkedAttention`, whose backward recomputes each chunk; f32
    operands and CPU tensors (which have no ``bmm.dtype`` kernel) widen to
    f32 first, which gives the same products since a narrow product is
    exact in f32, and differentiate through plain autograd."""
    if _narrow_operands(k):
        return ChunkedAttention.apply(q, k, v, causal, window, chunk)
    out, _, _ = _chunked_loop(q, k, v, causal, window, chunk)
    return out.reshape(q.shape).to(q.dtype)


def flash_part(q, k, v, mesh, *, causal: bool = True,
               window: Optional[int] = None):
    """This rank's K3 call in :func:`sharded_flash_attention`, as a
    zero-argument callable: q's block of the batch over the FSDP axes of
    ``mesh`` and of the sequence over "model", against its batch rows'
    whole K and V, at ``q_offset = model index * S_loc`` and the tiles of
    the one-device call (``flash_attention.ops.tiles`` of the whole
    sequence).  S_loc must be a multiple of that call's q tile."""
    from repro_torch.kernels import engine
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.parallel.sharding import FSDP, TP, axis_sizes
    sizes = axis_sizes(mesh)
    n_dp, dp_idx = 1, 0
    for a in FSDP:
        if a in sizes:
            n_dp, dp_idx = n_dp * sizes[a], dp_idx * sizes[a] + \
                mesh.get_local_rank(a)
    n_tp, tp_idx = engine.mesh_axis(mesh, TP)
    B, _, S, _ = q.shape
    Skv = k.shape[2]
    bq, bk = fops.tiles(q, k)
    s_loc = S // n_tp
    if B % n_dp or S % n_tp or s_loc % bq:
        raise ValueError(
            f"sharded_flash_attention: B {B} over {n_dp} data ranks and S "
            f"{S} over {n_tp} model ranks must split evenly, each sequence "
            f"part a multiple of K3's q tile {bq}")
    b_loc = B // n_dp
    kp = (-Skv) % bk
    kb, vb = (fops.pad_seq(engine.part(t, 0, b_loc, dp_idx), kp)
              for t in (k, v))
    qb = engine.part(engine.part(q, 0, b_loc, dp_idx), 2, s_loc, tp_idx)
    return lambda: fk.flash_attention(
        qb, kb, vb, causal=causal, window=window, bq=bq, bk=bk,
        q_offset=tp_idx * s_loc, skv=Skv)


def sharded_flash_attention(q, k, v, *, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """The flash kernel K3 with q split over ``parallel.context.MESH``:
    the batch over the FSDP axes the mesh has, the sequence over "model"
    (:func:`flash_part`), the blocks gathered, so every rank returns what
    the one-device K3 returns, bit for bit.  With no mesh, or under
    ``context.ACT_SPEC`` (the sharded train step, whose q, k and v are
    this rank's heads already), ``flash_attention.ops.attention`` (no
    oracle fallback), as the reference."""
    from repro_torch.kernels import engine
    from repro_torch.parallel import context
    from repro_torch.parallel.sharding import FSDP, TP
    mesh = context.MESH
    if mesh is None or context.ACT_SPEC is not None:
        # (under ACT_SPEC q, k and v are already this rank's heads)
        return fops.attention(q, k, v, causal=causal, window=window,
                              fallback="error")
    out = engine.gather(flash_part(q, k, v, mesh, causal=causal,
                                   window=window)(), 2, mesh, TP)
    for a in reversed(FSDP):       # the innermost FSDP axis first
        if a in mesh.mesh_dim_names:
            out = engine.gather(out, 0, mesh, a)
    return out


class FlashFwdChunkedBwd(torch.autograd.Function):
    """Attention with the flash kernel K3 on the forward
    (:func:`sharded_flash_attention`: split over ``parallel.context.MESH``
    when one is set, else ``flash_attention.ops.attention``, no oracle
    fallback) and the chunked VJP on the backward (:func:`_chunked_vjp` on
    the full q, k, v after the chunked loop's statistics are recomputed),
    the reference's ``flash_fwd_chunked_bwd``: what lets a train step run
    the kernel forward.  Causal, with an optional window."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return sharded_flash_attention(q, k, v, causal=True, window=window)

    @staticmethod
    def backward(ctx, g_out):
        q, k, v = ctx.saved_tensors
        with torch.no_grad():
            out, m, l = _chunked_loop(q, k, v, True, ctx.window, CHUNK)
            grads = _chunked_vjp(q, k, v, g_out, out, m, l, True,
                                 ctx.window, CHUNK)
        return grads + (None,)


@functools.lru_cache(maxsize=16)
def _layer_mask(spec: AttnMaskSpec, S: int, window: Optional[int], bq: int,
                bk: int):
    """The spec's mask for a prefill of S tokens, built once and shared by
    every layer of that geometry."""
    return spec.build(S, S, layer_window=window, bq=bq, bk=bk)


def _masked_prefill_attention(q, k, v, spec: AttnMaskSpec,
                              window: Optional[int]):
    """Prefill through the masked flash kernels when the spec applies to
    this layer (sliding-window layers via ``spec.local``, full-attention
    layers via ``spec.pattern``); None -> the caller takes its ``impl``.
    Tiles not given by the spec come from the ``flash`` row of the device's
    tuning table."""
    S, D = q.shape[2], q.shape[3]
    bq, bk = spec.bq, spec.bk
    if bq is None or bk is None:
        tbq, tbk = tuning.flash_tiles(S, S, D, q.dtype, q.device)
        bq, bk = bq or tbq, bk or tbk
    mask = _layer_mask(spec, S, window, bq, bk)
    if mask is None:
        return None
    return fops.attention(q, k, v, mask=mask, mask_impl=spec.impl)


def _heads_to_sequence(t: torch.Tensor, cache_axis) -> torch.Tensor:
    """A collected cache (B, H_loc, L, hd) of this rank's heads over the
    whole sequence -> (B, H, L / n, hd), every head over this rank's part
    of it: one all-to-all over "model" (part j of the sequence to rank j,
    the heads received in rank order).  The cache's sequence must be split
    over "model" (``cache_axis``), whose ranks hold the heads."""
    if cache_axis != TP:
        raise ValueError(f"prefill under a mesh collects a cache split over "
                         f"{TP!r}, not {cache_axis!r}")
    ax = tp.axis(TP)
    B, h, L, hd = t.shape
    parts = t.reshape(B, h, ax.n, L // ax.n, hd).permute(2, 0, 1, 3, 4)
    got = tp.all_to_all(parts.contiguous(), ax.group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, ax.n * h, L // ax.n, hd)


def split_decode_attention(q, k, v, *, kv_len, window: Optional[int],
                           cache_axis) -> torch.Tensor:
    """``decode_attention`` of q (B, Hq, 1, D) over a cache whose sequence
    is split over the mesh axis ``cache_axis``: ``k`` / ``v`` (B, Hkv,
    S_loc, D) are this rank's part, positions ``i S_loc ..`` (``i`` its
    index on the axis); ``kv_len`` and ``window`` the whole row's.  D1's
    split mode: the part's max, all-reduced (max) over the axis, then its
    partial sums against it, all-gathered and merged in rank order
    (``flash_attention.ops.decode_merge``), so every rank returns the same
    bits.  ``cache_axis`` None: the whole cache, one-device D1."""
    if cache_axis is None:
        return fops.decode_attention(q, k, v, kv_len=kv_len, window=window)
    seq = tp.axis(cache_axis)
    off = seq.index * k.shape[2]
    m = tp.all_reduce_max(fops.decode_attention_max(
        q, k, kv_len=kv_len, window=window, offset=off), seq.group)
    acc, l = fops.decode_attention_partial(q, k, v, m, kv_len=kv_len,
                                           window=window, offset=off)
    parts = tp.all_gather(torch.cat([acc, l[..., None]], dim=-1)[None], 0,
                          seq.group, seq.n)
    return fops.decode_merge(parts[..., :-1], parts[..., -1], q.dtype)


def _decode_on_mesh(p, x: torch.Tensor, cfg: ArchConfig,
                    window: Optional[int], cache, cache_len, cache_axis):
    """One-token decode under ``context.ACT_SPEC``: ``x`` (B, 1, d) the
    same on every rank of "model", the weights this rank's heads, ``cache``
    this rank's part (B, Hkv, S_loc, hd).  q, k and v of the rank's heads
    are gathered over "model" in one call, so every rank has every head;
    the new key / value is written, per row, only on the rank whose part
    holds the row's slot (``pos``, or ``pos % window`` in a ring: a local
    layer's cache of ``window`` slots in all); D1's split mode runs over
    the part (:func:`split_decode_attention`).  Returns this rank's heads
    of the output (B, Hq_loc, 1, hd)."""
    if "k_scale" in cache:
        raise ValueError("a quantized decode cache under a mesh is not "
                         "ported")
    B, hd = x.shape[0], cfg.hd
    h_q, h_kv = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    model = tp.axis(TP)
    n_seq, i_seq = ((1, 0) if cache_axis is None else
                    tp.axis(cache_axis)[1:])
    s_loc = cache["k"].shape[2]
    ring = bool(window) and s_loc * n_seq == window
    if isinstance(cache_len, torch.Tensor):
        pos = cache_len.reshape(-1).long().expand(B)
    else:
        pos = torch.full((B,), int(cache_len), device=x.device)
    q, k1, v1 = _qkv(p, x, cfg, pos[:, None, None], row_order=True)
    every = tp.all_gather(torch.cat([q, k1, v1], dim=1)[:, None], 1,
                          model.group, model.n)   # (B, n, h_q + 2 h_kv, ..)
    q, k1, v1 = (t.reshape(B, -1, 1, hd)
                 for t in every.split([h_q, h_kv, h_kv], dim=2))
    local = (pos % window if ring else pos) - i_seq * s_loc
    held = ((local >= 0) & (local < s_loc))[:, None, None]
    at = (torch.arange(B, device=x.device), slice(None),
          local.clamp(0, s_loc - 1))
    for name, new in (("k", k1[:, :, 0]), ("v", v1[:, :, 0])):
        c = cache[name]
        c[at] = torch.where(held, new.to(c.dtype), c[at])
    kv_len = pos.clamp(max=window - 1) + 1 if ring else pos + 1
    out = split_decode_attention(q, cache["k"], cache["v"], kv_len=kv_len,
                                 window=None if ring else window,
                                 cache_axis=cache_axis)
    return out[:, model.index * h_q:(model.index + 1) * h_q]


def _decode_one_device(p, x: torch.Tensor, cfg: ArchConfig,
                       window: Optional[int], cache, cache_len):
    """One-token decode on whole tensors (:func:`apply_attention`'s
    decode): writes the new key / value into ``cache``, returns the
    attention output (B, Hq, 1, hd)."""
    B = x.shape[0]
    quant = "k_scale" in cache
    # a local layer's cache of exactly `window` slots is a ring: the
    # write at slot pos % window, every filled slot visible
    ring = bool(window) and cache["k"].shape[2] == window
    if isinstance(cache_len, torch.Tensor):
        pos = cache_len.reshape(B).long()
        q, k1, v1 = _qkv(p, x, cfg, pos[:, None, None], row_order=True)
        # (row b, every head, slot of pos[b]) <- (B, Hkv, hd)
        at = (torch.arange(B, device=x.device), slice(None),
              pos % window if ring else pos)
        kv_len = pos.clamp(max=window - 1) + 1 if ring else pos + 1
    else:
        pos = cache_len
        q, k1, v1 = _qkv(p, x, cfg,
                         torch.full((1,), pos, device=x.device),
                         row_order=True)
        at = (slice(None), slice(None), pos % window if ring else pos)
        kv_len = min(pos + 1, window) if ring else pos + 1
    for name, new in (("k", k1[:, :, 0]), ("v", v1[:, :, 0])):
        if quant:
            qn = precision.quant_name(cache[name].dtype)
            new, cache[name + "_scale"][at] = precision.quantize_rows(
                new, qn, check=False)
        cache[name][at] = new.to(cache[name].dtype)
    kc, vc = cache["k"], cache["v"]
    if quant:
        kc, vc = (precision.dequantize_rows(cache[n], cache[n + "_scale"],
                                            q.dtype) for n in ("k", "v"))
    return fops.decode_attention(q, kc, vc, kv_len=kv_len,
                                 window=None if ring else window)


def apply_attention(p, x: torch.Tensor, cfg: ArchConfig, *,
                    window: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None,
                    impl: str = "chunked", cache=None,
                    cache_len=None, collect_kv: int = 0,
                    kv_quant: Optional[str] = None,
                    attn_mask: Optional[AttnMaskSpec] = None,
                    cache_axis=None):
    """Self-attention (prefill) or one-step decode when ``cache`` is given.

    Prefill: ``impl`` is one of :data:`IMPLS`; ``attn_mask`` (an
    ``AttnMaskSpec``) takes precedence where it applies.  ``collect_kv`` > 0
    also returns a fresh cache of that capacity holding this call's
    keys/values; with a ``window`` and ``S >= window`` that cache is the
    ring of the last ``window`` positions, each at slot ``pos % window``
    (the reference's ``argsort``).  Decode ignores ``impl`` and
    ``attn_mask``, as in the reference, and sums qk_norm's squares in row
    order (:func:`rmsnorm`).  A decode cache of exactly ``window``
    positions is a ring (the reference's ``_decode_block_attn``): the new
    key / value goes to slot ``pos % window`` and every filled slot is
    visible (``kv_len = min(pos + 1, window)``, no window); a longer one
    is a full cache under the window.
    cache: dict(k=(B, Hkv, L, hd), v=...) -- **updated in place**: decode
    writes the new key/value at ``cache_len`` and returns the same dict.
    ``cache_len`` is a Python int, the fill of every row, or a ``(B,)`` int
    tensor of per-row fills (continuous batching: RoPE, the write and the
    attention's length run at each row's own position; at equal positions
    the values are those of the int).
    ``kv_quant`` (a narrow dtype name; full-context layers only, as in the
    reference): the collected cache is stored per position as narrow
    values and f32 scales over head_dim (``k`` / ``k_scale``, ``v`` /
    ``v_scale``; ``precision.quantize_rows``).  Decode knows a quantized
    cache by its ``k_scale`` leaf: the new key / value is quantized the
    same way and written with its scales, then the whole cache is
    dequantized to q's dtype for ``decode_attention``.  Neither reads
    anything back to the host (the quantizer's non-finite check is off,
    as the reference's is under jit), so a decode step can be captured.
    Under ``context.ACT_SPEC`` the decode cache is this rank's part, every
    head over the slots of its index on the mesh axis ``cache_axis`` (None:
    the whole sequence): prefill collects it by :func:`_heads_to_sequence`
    (``kv_quant`` refused), decode runs :func:`_decode_on_mesh`.
    Returns (out, new_cache)."""
    if impl not in IMPLS:
        raise NotImplementedError(
            f"apply_attention impl={impl!r}: {IMPLS} are ported")
    on_mesh = tp.active()
    if on_mesh:
        x = tp.enter(x)             # column-parallel products
    B, S, _ = x.shape
    if cache is None:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q, k, v = _qkv(p, x, cfg, positions)
        out = None
        if attn_mask is not None:
            out = _masked_prefill_attention(q, k, v, attn_mask, window)
        if out is None:
            if impl == "kernel":
                out = fops.attention(q, k, v, causal=True, window=window)
            elif impl == "kernel_sharded":
                out = FlashFwdChunkedBwd.apply(q, k, v, window)
            elif impl == "chunked":
                out = chunked_attention(q, k, v, causal=True, window=window)
            else:
                out = attention_ref(q, k, v, causal=True, window=window)
        new_cache = None
        if collect_kv:
            if window and S >= window:
                # the ring: the last `window` positions at their slots
                # (pos % window), one permutation built on the device
                order = torch.argsort(positions[-window:] % window)
                kc, vc = (t[:, :, -window:].index_select(2, order)
                          for t in (k, v))
            else:
                cap = min(collect_kv, window) if window else collect_kv
                kc, vc = (F.pad(t, (0, 0, 0, cap - S)) for t in (k, v))
            if on_mesh:
                if kv_quant is not None:
                    raise ValueError("kv_quant under a mesh is not ported")
                kc, vc = (_heads_to_sequence(t, cache_axis)
                          for t in (kc, vc))
            if kv_quant is not None and not window:
                (qk, sk), (qv, sv) = (precision.quantize_rows(
                    t, kv_quant, check=False) for t in (kc, vc))
                new_cache = {"k": qk, "k_scale": sk, "v": qv, "v_scale": sv}
            else:
                new_cache = {"k": kc, "v": vc}
    else:
        if S != 1:
            raise ValueError(f"apply_attention decode takes one token, got {S}")
        if on_mesh:
            out = _decode_on_mesh(p, x, cfg, window, cache, cache_len,
                                  cache_axis)
        else:
            out = _decode_one_device(p, x, cfg, window, cache, cache_len)
        new_cache = cache
    out = out.transpose(1, 2).reshape(B, S, -1)
    out = out @ p["wo"].to(out.dtype)
    if on_mesh:
        out = tp.leave(out)         # the row-parallel product's partial sums
    return out, new_cache


# ------------------------------------------------------------------- mlp ----

def apply_mlp(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The MLP on x (..., d).  Under ``context.ACT_SPEC`` x is the residual
    stream's (B_loc, S_loc, d) and the weights this rank's "model" share:
    column-parallel ``w_gate`` / ``w_up``, row-parallel ``w_down``, with
    ``parallel.collectives.enter`` / ``leave`` around them."""
    cd = x.dtype
    if tp.active():
        x = tp.enter(x)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"].to(cd)) * (x @ p["w_up"].to(cd))
    else:  # squared_relu (Nemotron-4)
        h = torch.square(F.relu(x @ p["w_up"].to(cd)))
    out = h @ p["w_down"].to(cd)
    return tp.leave(out) if tp.active() else out
