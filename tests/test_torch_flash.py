"""Port vs reference: the flash-attention kernels K3, K4m, K4s and ``ops``.

On the CPU the port's wrappers take their plain versions (``ref.py``, the
kernels' tile loop in PyTorch); the reference runs its Pallas kernels in
interpret mode.  Same numpy-seeded f32 inputs through both, ``atol = rtol =
1e-5``: the frameworks sum the tile products in other orders, nothing else
differs.  Inside the port the kernels' laws hold exactly (``torch.equal``):
sparse walk == masked grid, sparse walk on a plain causal / window mask ==
K3, and bucket padding changes nothing.

On the card bf16 q, k, v take a tensor-core tile update that keeps p at f32
precision as a bf16 hi + lo pair; ``test_bf16_split_*`` emulates its
arithmetic here and holds it against the plain versions' f32 p.
"""
import collections
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as R
from repro_torch.core.masks import KIND_CAUSAL, KIND_WINDOW, NEG_INF
from repro.kernels import tuning as r_tuning
from repro.kernels.flash_attention import kernel as rk
from repro.kernels.flash_attention import ops as r_ops

from repro_torch.core import masks as P
from repro_torch.kernels import build, tuning
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(B=2, Hq=4, Hkv=2, Sq=64, Skv=96, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in
                 ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _zoo(m, sq, skv, bq, bk):
    local = m.BlockMask.sliding_window(sq, skv, 3 * bk, bq=bq, bk=bk)
    return {
        "causal": m.BlockMask.causal(sq, skv, bq=bq, bk=bk),
        "window": m.BlockMask.sliding_window(sq, skv, 2 * bk, bq=bq, bk=bk),
        "strided": m.BlockMask.strided(sq, skv, 2, bq=bq, bk=bk),
        "global": m.BlockMask.global_cols(sq, skv, 1, bq=bq, bk=bk),
        "local|global": local | m.BlockMask.global_cols(sq, skv, 1,
                                                        bq=bq, bk=bk),
        "strided&causal": (m.BlockMask.strided(sq, skv, 2, bq=bq, bk=bk)
                           & m.BlockMask.causal(sq, skv, bq=bq, bk=bk)),
    }


@pytest.mark.parametrize("name", list(_zoo(R, 64, 64, 16, 16)))
def test_sparse_and_masked_match_reference(name):
    """K4s and K4m (plain) vs the reference's K4s in interpret mode, which
    the reference holds bit-equal to its K4m; inside the port sparse ==
    masked exactly."""
    bq = bk = 16
    q, k, v = _qkv()
    rm, pm = _zoo(R, 64, 96, bq, bk)[name], _zoo(P, 64, 96, bq, bk)[name]
    rs, ps = rm.lower(bucket=True), pm.lower(bucket=True)
    want = np.asarray(rk.flash_attention_sparse(
        *_j(q, k, v), rs.rows, rs.cols, rs.kinds, skv=96, window=rm.window,
        bq=bq, bk=bk, interpret=True))
    sparse = fk.flash_attention_sparse(
        *_t(q, k, v), ps.rows, ps.cols, ps.kinds, skv=96, window=pm.window,
        bq=bq, bk=bk)
    masked = fk.flash_attention_masked(*_t(q, k, v), pm.tile_kinds, skv=96,
                                       window=pm.window)
    np.testing.assert_allclose(sparse.numpy(), want, **TOL)
    assert torch.equal(sparse, masked)
    # and both agree with the materialized oracle
    np.testing.assert_allclose(
        sparse.numpy(), ref.attention_ref(*_t(q, k, v), mask=pm).numpy(),
        atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window,q_offset,gqa,D", [
    (None, 0, (4, 2), 16), (24, 0, (4, 2), 16), (None, 32, (2, 2), 16),
    (40, 16, (4, 1), 16), (None, 0, (2, 1), 256), (24, 0, (2, 1), 256)])
def test_flash_matches_reference_and_sparse_law(window, q_offset, gqa, D):
    """K3 (plain) vs the reference K3 in interpret mode, at head dims 16 and
    256 (gemma3-12b's); and the sparse walk on ``BlockMask.full(causal[,
    window])`` equals K3 exactly."""
    bq = bk = 16
    q, k, v = _qkv(B=1 if D == 256 else 2, Hq=gqa[0], Hkv=gqa[1], Sq=64,
                   Skv=96, D=D)
    want = np.asarray(rk.flash_attention(
        *_j(q, k, v), causal=True, window=window, bq=bq, bk=bk,
        q_offset=q_offset, interpret=True))
    got = fk.flash_attention(*_t(q, k, v), causal=True, window=window,
                             bq=bq, bk=bk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    m = P.BlockMask.full(64, 96, bq=bq, bk=bk, causal=True, window=window,
                         q_offset=q_offset)
    s = m.lower(bucket=True)
    sparse = fk.flash_attention_sparse(
        *_t(q, k, v), s.rows, s.cols, s.kinds, skv=96, window=window,
        bq=bq, bk=bk, q_offset=q_offset)
    assert torch.equal(sparse, got)


@pytest.mark.parametrize("window,q_offset,gqa", [
    (None, 0, (12, 1)), (24, 0, (12, 1)), (None, 16, (6, 2))])
def test_flash_at_head_dim_192_matches_reference(window, q_offset, gqa):
    """Head dim 192 (nemotron-4-340b's, GQA group 12 as in its CONFIG): K3
    (plain) vs the reference K3 in interpret mode; the sparse walk on
    ``BlockMask.full(causal[, window])`` equals K3 exactly."""
    bq = bk = 16
    q, k, v = _qkv(B=1, Hq=gqa[0], Hkv=gqa[1], Sq=48, Skv=64, D=192,
                   seed=5)
    want = np.asarray(rk.flash_attention(
        *_j(q, k, v), causal=True, window=window, bq=bq, bk=bk,
        q_offset=q_offset, interpret=True))
    got = fk.flash_attention(*_t(q, k, v), causal=True, window=window,
                             bq=bq, bk=bk, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    m = P.BlockMask.full(48, 64, bq=bq, bk=bk, causal=True, window=window,
                         q_offset=q_offset)
    s = m.lower(bucket=True)
    sparse = fk.flash_attention_sparse(
        *_t(q, k, v), s.rows, s.cols, s.kinds, skv=64, window=window,
        bq=bq, bk=bk, q_offset=q_offset)
    assert torch.equal(sparse, got)


@pytest.mark.parametrize("name", ["causal", "strided", "local|global"])
def test_sparse_and_masked_at_head_dim_192_match_reference(name):
    """K4s and K4m (plain) at head dim 192, GQA 12/1, a ragged KV tail
    (skv 88 of 96) vs the reference's K4s in interpret mode; sparse ==
    masked exactly."""
    bq = bk = 16
    q, k, v = _qkv(B=1, Hq=12, Hkv=1, Sq=64, Skv=96, D=192, seed=6)
    rm, pm = _zoo(R, 64, 96, bq, bk)[name], _zoo(P, 64, 96, bq, bk)[name]
    rs, ps = rm.lower(bucket=True), pm.lower(bucket=True)
    want = np.asarray(rk.flash_attention_sparse(
        *_j(q, k, v), rs.rows, rs.cols, rs.kinds, skv=88, window=rm.window,
        bq=bq, bk=bk, interpret=True))
    sparse = fk.flash_attention_sparse(
        *_t(q, k, v), ps.rows, ps.cols, ps.kinds, skv=88, window=pm.window,
        bq=bq, bk=bk)
    masked = fk.flash_attention_masked(*_t(q, k, v), pm.tile_kinds, skv=88,
                                       window=pm.window)
    np.testing.assert_allclose(sparse.numpy(), want, **TOL)
    assert torch.equal(sparse, masked)


def test_bucketed_stream_is_noop_and_empty_rows_zero():
    bq = bk = 16
    q, k, v = _t(*_qkv(Sq=64, Skv=64))
    m = P.BlockMask.sliding_window(64, 64, 32, bq=bq, bk=bk)
    outs = []
    for kw in ({"bucket": False}, {"bucket": True},
               {"bucket": True, "min_bucket": 64}):
        s = m.lower(**kw)
        outs.append(fk.flash_attention_sparse(
            q, k, v, s.rows, s.cols, s.kinds, skv=64, window=m.window,
            bq=bq, bk=bk))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    # a q-tile row with no visible tile is an empty-row marker: zeros
    kinds = m.tile_kinds.copy()
    kinds[2] = P.KIND_DEAD
    dead = P.BlockMask(64, 64, bq, bk, kinds, window=m.window)
    s = dead.lower()
    out = fk.flash_attention_sparse(q, k, v, s.rows, s.cols, s.kinds,
                                    skv=64, window=m.window, bq=bq, bk=bk)
    assert out[:, :, 2 * bq:3 * bq].abs().max() == 0
    assert torch.equal(out, fk.flash_attention_masked(
        q, k, v, kinds, skv=64, window=m.window))


@pytest.mark.parametrize("impl", ["sparse", "dense"])
def test_ragged_gqa_via_ops_matches_reference(impl):
    """ops.attention pads ragged S to tiles; GQA heads share KV."""
    q, k, v = _qkv(B=2, Hq=4, Hkv=2, Sq=52, Skv=52)
    rm = R.BlockMask.sliding_window(52, 52, 24, bq=16, bk=16)
    pm = P.BlockMask.sliding_window(52, 52, 24, bq=16, bk=16)
    want = np.asarray(r_ops.attention(*_j(q, k, v), mask=rm, mask_impl=impl,
                                      interpret=True))
    got = ops.attention(*_t(q, k, v), mask=pm, mask_impl=impl)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    other = ops.attention(*_t(q, k, v), mask=pm,
                          mask_impl="dense" if impl == "sparse" else "sparse")
    assert torch.equal(got, other)


@pytest.mark.parametrize("S,Skv,bq,bk,window,causal", [
    (52, 52, 16, 16, None, True), (40, 40, None, None, None, True),
    (72, 72, 16, 8, 20, True), (16, 13, 8, 8, None, False),
    (52, 44, 16, 16, None, False)])
def test_flash_via_ops_matches_reference(S, Skv, bq, bk, window, causal):
    """K3 through ops.attention: the reference's tile re-clamp and padding,
    CPU tuning rows when no tiles are given.  A ragged non-causal KV runs on
    K3 too, its padded keys masked by the true KV length (the reference
    takes its oracle there)."""
    q, k, v = _qkv(B=1, Hq=4, Hkv=2, Sq=S, Skv=Skv)
    want = np.asarray(r_ops.attention(*_j(q, k, v), causal=causal,
                                      window=window, bq=bq, bk=bk,
                                      interpret=True))
    ops.reset_fallbacks()
    got = ops.attention(*_t(q, k, v), causal=causal, window=window, bq=bq,
                        bk=bk, fallback="error")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert ops.fallback_count() == 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["causal", "full", "window", "sparse",
                                  "dense"])
def test_chip_smokes_plain_side_is_ops_plain_path(case, dt):
    """``chip_smoke._ops_plain`` runs ``ops.attention``'s plain path on the
    tensors' own device, so that the card's kernel is held against its plain
    version on the card: on CPU tensors it equals ``ops.attention`` as
    ``torch.equal``, ragged S (padding, the KV tail) and default tiles
    included."""
    q, k, v = (t.to(dt) for t in _t(*_qkv(B=2, Hq=4, Hkv=2, Sq=52,
                                          Skv=52)))
    m = (P.BlockMask.sliding_window(52, 52, 32, bq=16, bk=16)
         | P.BlockMask.global_cols(52, 52, 1, bq=16, bk=16))
    kw = {"causal": dict(causal=True, bq=16, bk=16),
          "full": dict(causal=False, bq=16, bk=16),
          "window": dict(causal=True, window=20),
          "sparse": dict(mask=m, mask_impl="sparse"),
          "dense": dict(mask=m, mask_impl="dense")}[case]
    got = _chip_smoke()._ops_plain(q, k, v, **kw)
    assert torch.equal(got, ops.attention(q, k, v, **kw))


def test_fallback_counter_and_error_knob():
    q, k, v = _t(*_qkv(B=1, Hq=2, Hkv=2, Sq=16, Skv=16))
    ops.reset_fallbacks()
    ops.attention(q, k, v, use_kernel=False)
    assert ops.fallback_count() == 1
    assert ops.fallback_reasons() == {"use_kernel=False": 1}
    # no shape forces the oracle: a non-causal ragged KV runs on K3, its
    # padded keys masked
    q2, k2, v2 = _t(*_qkv(B=1, Hq=2, Hkv=2, Sq=16, Skv=13))
    got = ops.attention(q2, k2, v2, causal=False, bq=8, bk=8,
                        fallback="error")
    assert ops.fallback_count() == 1
    np.testing.assert_allclose(
        got.numpy(), ref.attention_ref(q2, k2, v2, causal=False).numpy(),
        **TOL)
    m = P.BlockMask.causal(16, 16, bq=8, bk=8)
    ops.attention(q, k, v, mask=m, mask_impl="ref")
    assert ops.fallback_count() == 2
    with pytest.raises(RuntimeError, match="fallback='error'"):
        ops.attention(q, k, v, use_kernel=False, fallback="error")
    with pytest.raises(RuntimeError, match="fallback='error'"):
        ops.attention(q, k, v, mask=m, mask_impl="ref", fallback="error")
    with pytest.raises(ValueError):
        ops.attention(q, k, v, mask=m, mask_impl="bogus")
    # the kernel paths never touch the oracle
    for impl in ("sparse", "dense"):
        ops.attention(q, k, v, mask=m, mask_impl=impl, fallback="error")
    ops.attention(q, k, v, fallback="error")
    assert ops.fallback_count() == 2
    ops.reset_fallbacks()
    assert ops.fallback_count() == 0


def test_cpu_tensors_take_the_plain_path():
    """A CPU tensor never launches (and never builds) a kernel."""
    before = (fk.flash_attention.launches, fk.flash_attention_masked.launches,
              fk.flash_attention_sparse.launches)
    q, k, v = _t(*_qkv(B=1, Hq=2, Hkv=2, Sq=16, Skv=16))
    m = P.BlockMask.causal(16, 16, bq=8, bk=8)
    s = m.lower()
    a = fk.flash_attention(q, k, v, bq=8, bk=8)
    b = fk.flash_attention_masked(q, k, v, m.tile_kinds, skv=16)
    c = fk.flash_attention_sparse(q, k, v, s.rows, s.cols, s.kinds, skv=16,
                                  bq=8, bk=8)
    assert torch.equal(a, b) and torch.equal(b, c)
    assert (fk.flash_attention.launches, fk.flash_attention_masked.launches,
            fk.flash_attention_sparse.launches) == before


def test_masked_paths_lower_each_mask_once(monkeypatch):
    """The layers of a prefill share one mask: ops lowers and uploads it
    once, keyed by its signature, and a different mask is lowered anew."""
    lowered = []
    lower = P.BlockMask.lower

    def counted(self, **kw):
        lowered.append(self.signature())
        return lower(self, **kw)

    monkeypatch.setattr(P.BlockMask, "lower", counted)
    monkeypatch.setattr(ops, "_INDICES", collections.OrderedDict())
    q, k, v = _t(*_qkv(B=1, Hq=2, Hkv=2, Sq=48, Skv=48, seed=3))
    m = P.BlockMask.sliding_window(48, 48, 16, bq=8, bk=8)
    outs = [ops.attention(q, k, v, mask=mask, mask_impl="sparse")
            for mask in (m, m, P.BlockMask.sliding_window(48, 48, 16, bq=8,
                                                          bk=8))]
    assert len(lowered) == 1
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    ops.attention(q, k, v, mask=P.BlockMask.causal(48, 48, bq=8, bk=8),
                  mask_impl="sparse")
    assert len(lowered) == 2 and lowered[0] != lowered[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuning_rows(dtype):
    """CPU tiles equal the reference's CPU tiles, dense and masked (so CPU
    masks do); the card's tiles fit the kernels (at most 64, within shared
    memory)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for sq, skv, d in ((2048, 2048, 128), (52, 52, 16), (6, 6, 16),
                       (300, 4096, 64)):
        got = tuning.flash_tiles(sq, skv, d, dtype)
        assert got == r_tuning.flash_tiles(sq, skv, d, jdt)
        assert got == r_tuning.flash_sparse_tiles(sq, skv, d, jdt,
                                                  pattern="local_global")
        bq, bk = tuning.flash_tiles(sq, skv, d, dtype, "cuda")
        assert 1 <= bq <= tuning.FLASH_MAX_TILE
        assert 1 <= bk <= tuning.FLASH_MAX_TILE
        assert tuning.flash_smem_bytes(bq, bk, d, dtype) \
            <= tuning.SMEM_BUDGET
    # the slice's shape: 64 x 64 tiles (so the serving mask keeps 275 of
    # 1024 visible tiles); bf16 stages a (64, 128) Q tile and three K / V
    # stages (+ 1 KB alignment), f32 the padded f32 Q, K, V and score tiles
    assert tuning.flash_tiles(2048, 2048, 128, dtype, "cuda") == (64, 64)
    assert tuning.flash_smem_bytes(64, 64, 128, dtype) == {
        torch.bfloat16: 1024 + 7 * 64 * 128 * 2,
        torch.float32: 4 * (2 * 64 * 129 + 64 * 128 + 64 * 65)}[dtype]
    # gemma3-12b's head dim 256: one block an SM, still 64 x 64 tiles
    # (230,400 bytes bf16, 213,760 f32, within the 232,448 a block has)
    assert tuning.flash_tiles(1536, 1536, 256, dtype, "cuda") == (64, 64)
    assert tuning.flash_smem_bytes(64, 64, 256, dtype) == {
        torch.bfloat16: 230400, torch.float32: 213760}[dtype] \
        <= tuning.SMEM_BUDGET
    # nemotron-4-340b's head dim 192: 64 x 64 tiles, one block an SM
    # (173,056 bytes bf16, 164,608 f32)
    assert tuning.flash_tiles(1024, 1024, 192, dtype, "cuda") == (64, 64)
    assert tuning.flash_smem_bytes(64, 64, 192, dtype) == {
        torch.bfloat16: 173056, torch.float32: 164608}[dtype] \
        <= tuning.SMEM_BUDGET


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """A library is named after its whole ``csrc/`` directory: an edited
    header beside a source rebuilds it, as an edited source does."""
    src = tmp_path / "kern.cu"
    header = tmp_path / "helpers.cuh"
    src.write_text('#include "helpers.cuh"\n')
    header.write_text("// v1\n")
    monkeypatch.setitem(build.SOURCES, "probe", src)
    first = build.library_path("probe")
    assert build.library_path("probe") == first
    header.write_text("// v2\n")
    second = build.library_path("probe")
    assert second != first
    src.write_text('#include "helpers.cuh"\n// edited\n')
    assert build.library_path("probe") not in (first, second)


# ----------------------------------------- the bf16 tensor-core arithmetic --

def _tc_update(split: bool):
    """The bf16 kernels' tile update in plain PyTorch: s = (q k^T in f32
    from bf16 inputs) * scale, the online softmax in f32, and P V with p as
    a bf16 hi + lo pair summed in f32 (``split``), or p rounded to bf16
    alone.  Takes the unscaled Q tile with the scale (see ``_tc_q_tile``)."""
    def update(st, q_and_scale, k, v, *, kind, q0, k0, window, skv):
        qf, scale = q_and_scale
        B, Hq, bq, D = qf.shape
        Hkv, bk = k.shape[1], k.shape[2]
        g = Hq // Hkv
        m, l, acc = st
        s = torch.matmul(qf.reshape(B, Hkv, g, bq, D),
                         k.float()[:, :, None].transpose(-1, -2))
        s = s.reshape(B, Hq, bq, bk) * scale
        q_pos = q0 + torch.arange(bq)[:, None]
        k_pos = k0 + torch.arange(bk)[None, :]
        mask = k_pos < skv
        if kind & KIND_CAUSAL:
            mask = mask & (q_pos >= k_pos)
        if window is not None and kind & KIND_WINDOW:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        hi = p.bfloat16().float()
        parts = (hi, (p - hi).bfloat16().float()) if split else (hi,)
        pv = sum(torch.matmul(x.reshape(B, Hkv, g, bq, bk),
                              v.float()[:, :, None]) for x in parts)
        st[0] = m_new
        st[1] = l * alpha + p.sum(dim=-1, keepdim=True)
        st[2] = acc * alpha + pv.reshape(B, Hq, bq, D)
    return update


def _tc_q_tile(q, qi, bq, scale):
    """The unscaled Q tile (exact in bf16) and the scale, applied to s."""
    return q[:, :, qi * bq:(qi + 1) * bq].float(), scale


@pytest.mark.parametrize("name", list(_zoo(R, 64, 64, 16, 16)))
def test_bf16_split_keeps_p_at_f32_precision(name, monkeypatch):
    """On bf16 inputs (held as f32, so nothing is rounded at the end), the
    tensor-core arithmetic with p = hi + lo lies within 1e-5 of the largest
    |value| of the plain versions (f32 p, q scaled first), through the same
    tile loops of K4s, K4m and K3; p rounded to bf16 alone lies beyond
    1e-4.  So the split, not luck, keeps the bf16 kernels within one bf16
    ulp of their plain versions on the card."""
    bq = bk = 16
    q, k, v = (t.bfloat16().float() for t in _t(*_qkv(D=64, seed=4)))
    m = _zoo(P, 64, 96, bq, bk)[name]
    s = m.lower(bucket=True)
    runs = {
        "K4s": lambda: ref.flash_attention_sparse_ref(
            q, k, v, s.rows, s.cols, s.kinds, skv=96, window=m.window,
            bq=bq, bk=bk),
        "K4m": lambda: ref.flash_attention_masked_ref(
            q, k, v, m.tile_kinds, skv=96, window=m.window)}
    if name in ("causal", "window"):
        runs["K3"] = lambda: ref.flash_attention_ref(
            q, k, v, causal=True, window=m.window, bq=bq, bk=bk)
    want = {kname: run() for kname, run in runs.items()}
    monkeypatch.setattr(ref, "_q_tile", _tc_q_tile)
    for kname, run in runs.items():
        big = want[kname].abs().max().item()
        monkeypatch.setattr(ref, "_tile_update", _tc_update(split=True))
        split = (run() - want[kname]).abs().max().item()
        monkeypatch.setattr(ref, "_tile_update", _tc_update(split=False))
        rounded = (run() - want[kname]).abs().max().item()
        assert split <= 1e-5 * big, (kname, split, big)
        assert rounded > 1e-4 * big, (kname, rounded, big)
