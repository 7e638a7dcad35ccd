"""D1 (``kernels/flash_attention/csrc/decode_attention.cu``) on the CPU: its
order of operations, emulated in PyTorch by ``ref.decode_attention_ordered``,
at caches long enough that the cluster's CTAs take several chunks each.

D1 runs only on the card, where ``chip_smoke.py`` holds it ``torch.equal``
to the emulation.  Held here:

* the emulation against the reference's ``decode_attention`` within
  :func:`_ulp_tol`, at 600-position caches (19 chunks of 32, so CTAs 0-2
  of the 8 take three), windows none, 7 and 300, per-row lengths, the four
  dtype pairings;
* the emulation ``torch.equal`` to a position-by-position walk of the
  order the kernel's source states (chunk c to CTA c mod 8, position i of a
  chunk to warp i mod 8, warps then CTAs added in order), and the kernel's
  transposed butterflies (16 scores reduced at once where pass 1 holds
  them, a position's 8 heads where pass 2 recomputes them) to the
  xor-butterfly the emulation takes, so held and recomputed scores share
  one emulation (that the two give equal bits on the card is checked by
  ``chip_smoke.py``'s 16,400-position case);
* its laws as ``torch.equal``: row i of B in 1-16 rows == the row alone;
  the same rows in caches of 600 and 1,100 positions; ``kv_len`` 0 gives
  zeros and 1 gives V's first row;
* the wrapper off the CPU (a fake library on ``meta`` tensors): it passes
  no scratch and allocates only its output;
* the split mode (a cache whose sequence is split over ranks): its plain
  versions (``ref.decode_split_max_ref`` / ``decode_split_partial_ref``)
  and its emulated order (``decode_split_*_ordered``), merged over 2 and
  4 shards by ``ref.decode_merge``, against the one-shot plain version; a
  shard with nothing visible (-inf, zeros, no NaN after the merge); the
  order's rows at B 1 ``torch.equal`` to the same rows at B 4; the
  wrappers' bindings against the source's C entry points.

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as rfops

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ref as fref

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]
WINDOWS = [None, 7, 300]
S = 600
LENS = (600, 1, 599, 257, 31, 300, 433, 64)    # kv_len of rows 0..7


def _t(a: np.ndarray, dt) -> torch.Tensor:
    return torch.from_numpy(a).to(dt)


def _inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    return q, k, v


def _ulp_tol(want: np.ndarray, *dtypes) -> float:
    """One ulp at the largest |value| of the narrowest dtype in play (p is
    rounded to the cache dtype, the output to q's: a score summed in another
    order can round either way), else 2e-6 of the largest |value| (f32
    sums in another order)."""
    big = float(np.abs(want).max())
    if all(dt == F32 for dt in dtypes):
        return 2e-6 * big
    return 2.0 ** np.floor(np.log2(big)) * torch.finfo(BF16).eps


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("qdt,cdt", PAIRS)
def test_order_matches_reference_on_long_rows(window, qdt, cdt):
    """GQA 10/2 (g 5), D 64, 8 rows of a 600-position cache at
    :data:`LENS`: within :func:`_ulp_tol` of the reference."""
    q, k, v = _inputs(0, len(LENS), 10, 2, S, 64)
    lens = np.asarray(LENS, np.int32)
    want = np.asarray(rfops.decode_attention(
        jnp.asarray(q).astype(JNP[qdt]), jnp.asarray(k).astype(JNP[cdt]),
        jnp.asarray(v).astype(JNP[cdt]), kv_len=jnp.asarray(lens),
        window=window).astype(jnp.float32))
    got = fref.decode_attention_ordered(_t(q, qdt), _t(k, cdt), _t(v, cdt),
                                        kv_len=torch.from_numpy(lens),
                                        window=window)
    assert got.dtype == qdt
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want, qdt,
                                                                cdt)


def _walk(q1, k_cache, v_cache, kv_len, window):
    """The order as the kernel's source states it, one position at a time:
    chunk c of 32 from lo to CTA c mod 8, position i of a chunk to warp i
    mod 8; each warp sums p and f32(cast(p)) v from zero; warps, then CTAs,
    added in order."""
    B, Hq, _, D = q1.shape
    _, Hkv, Scap, _ = k_cache.shape
    g, cd = Hq // Hkv, k_cache.dtype
    C, R, W = fref.DECODE_CHUNK, fref.DECODE_CTAS, fref.DECODE_WARPS
    qg = (q1.float() * torch.tensor(D ** -0.5)).to(q1.dtype).to(cd).float()
    out = torch.zeros((B, Hkv, g, D))
    for b in range(B):
        n = int(kv_len[b])
        hi, lo = min(n, Scap), max(0, n - window) if window else 0
        if hi <= lo:
            continue
        qb = qg[b].reshape(Hkv, g, D)
        s = {j: fref._decode_scores(qb, k_cache[b, :, j:j + 1].float())[
            ..., 0] for j in range(lo, hi)}                     # (Hkv, g)
        m = torch.stack(list(s.values())).amax(0)
        chunks = -(-(hi - lo) // C)
        o = l = None
        for r in range(R):
            oc = lc = None
            for w in range(W):
                lw, ow = torch.zeros((Hkv, g)), torch.zeros((Hkv, g, D))
                for c in range(r, chunks, R):
                    for i in range(w, C, W):
                        j = lo + c * C + i
                        if j < hi:
                            p = torch.exp(s[j] - m)
                            lw = lw + p
                            ow = ow + p.to(cd).float()[..., None] \
                                * v_cache[b, :, j].float()[:, None]
                oc, lc = (ow, lw) if oc is None else (oc + ow, lc + lw)
            o, l = (oc, lc) if o is None else (o + oc, l + lc)
        out[b] = o / torch.where(l == 0, 1.0, l)[..., None]
    return out.reshape(B, Hq, 1, D).to(q1.dtype)


@pytest.mark.parametrize("window", WINDOWS)
def test_order_is_the_stated_walk(window):
    """The emulation is ``torch.equal`` to :func:`_walk`, bf16, GQA 4/2, D
    16, rows of :data:`LENS` (lo off a chunk boundary under both
    windows)."""
    q, k, v = (_t(a, BF16) for a in _inputs(1, len(LENS), 4, 2, S, 16))
    kv = torch.tensor(LENS)
    assert torch.equal(
        fref.decode_attention_ordered(q, k, v, kv_len=kv, window=window),
        _walk(q, k, v, kv, window))


def _transpose_sum(x: torch.Tensor, levels=(16, 8, 4, 2),
                   plain=(1,)) -> torch.Tensor:
    """The kernel's ``transpose_sum`` on x (32 lanes, 16 values) as f32:
    at offsets ``levels`` a lane keeps the half of its values whose bit
    matches its own and adds its partner's partials of them, then at
    offsets ``plain`` each lane adds its partner's value (``transpose_sum8``
    on 8 values: levels 16, 8, 4, plain 2, 1).  Returns each lane's
    value."""
    lanes = torch.arange(32)
    for o in levels:
        n = x.shape[1] // 2
        up = (lanes & o).bool()[:, None]
        send = torch.where(up, x[:, :n], x[:, n:])
        keep = torch.where(up, x[:, n:], x[:, :n])
        x = keep + send[lanes ^ o]
    x = x[:, 0]
    for o in plain:
        x = x + x[lanes ^ o]
    return x


def _partials(seed: int, values: int) -> torch.Tensor:
    """(32 lanes, values) f32 partials spread over 12 binades, zeros and
    signs mixed."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(32, values))
         * 2.0 ** rng.integers(-6, 6, (32, values))).astype(np.float32)
    x[rng.random((32, values)) < 0.1] = 0.0
    return torch.from_numpy(x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transposed_butterfly_has_the_butterflys_bits(seed):
    """D1 reduces 16 scores at once (``transpose_sum``): lanes j and j ^ 1
    end with value j / 2, ``torch.equal`` to the xor-butterfly of that
    value's 32 partials (``ref._lane_sum``, the emulation's tree), on
    values spread over 12 binades with zeros and signs mixed."""
    x = _partials(seed, 16)
    got = _transpose_sum(x)
    want = fref._lane_sum(x.T)                      # (16,) one a value
    assert torch.equal(got, want[torch.arange(32) // 2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recomputed_scores_have_the_butterflys_bits(seed):
    """Where pass 2 recomputes a chunk's scores, D1 reduces a position's 8
    heads at once (``transpose_sum8``: levels 16, 8, 4 transposed, then 2
    and 1 plain) and lane l takes head ``(l >> 1) & 7`` from lane ``4 ((l
    >> 1) & 7)``: lanes 4 j .. 4 j + 3 end with head j, ``torch.equal`` to
    the xor-butterfly of its 32 partials (``ref._lane_sum``)."""
    x = _partials(seed, 8)
    got = _transpose_sum(x, levels=(16, 8, 4), plain=(2, 1))
    want = fref._lane_sum(x.T)                      # (8,) one a head
    lanes = torch.arange(32)
    assert torch.equal(got, want[lanes >> 2])
    assert torch.equal(got[((lanes >> 1) & 7) << 2], want[(lanes >> 1) & 7])


@pytest.mark.parametrize("dt", [F32, BF16])
def test_rows_do_not_depend_on_the_batch(dt):
    """Row i of the order at B rows is ``torch.equal`` to row i alone, for
    B in 1-16, per-row lengths up to 600, window 300."""
    q, k, v = (_t(a, dt) for a in _inputs(2, 16, 8, 1, S, 64))
    kv = torch.from_numpy(np.random.default_rng(3).integers(1, S + 1, 16))
    alone = [fref.decode_attention_ordered(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], kv_len=kv[i:i + 1],
                                           window=300) for i in range(16)]
    for B in range(1, 17):
        out = fref.decode_attention_ordered(q[:B], k[:B], v[:B],
                                            kv_len=kv[:B], window=300)
        for i in range(B):
            assert torch.equal(out[i:i + 1], alone[i]), (B, i)


@pytest.mark.parametrize("window", WINDOWS)
def test_order_ignores_the_capacity(window):
    """The same rows in caches of 600 and 1,100 positions, random values
    past every length in the larger one, give ``torch.equal`` outputs."""
    q, k, v = _inputs(4, len(LENS), 4, 2, S, 64)
    kb, vb = _inputs(5, len(LENS), 4, 2, 1100, 64)[1:]
    kb[:, :, :S], vb[:, :, :S] = k, v
    kv = torch.tensor(LENS)
    args = [_t(a, BF16) for a in (q, k, v)]
    big = [args[0], _t(kb, BF16), _t(vb, BF16)]
    assert torch.equal(
        fref.decode_attention_ordered(*args, kv_len=kv, window=window),
        fref.decode_attention_ordered(*big, kv_len=kv, window=window))


@pytest.mark.parametrize("qdt,cdt", PAIRS)
def test_lengths_zero_and_one(qdt, cdt):
    """``kv_len`` 0 gives zeros (no visible position); 1 gives V's first
    row in q's dtype (p = 1, l = 1), with and without a window."""
    q, k, v = (_t(a, dt) for a, dt in zip(_inputs(7, 3, 4, 2, 64, 64),
                                          (qdt, cdt, cdt)))
    for window in (None, 7):
        zero = fref.decode_attention_ordered(q, k, v, kv_len=0,
                                             window=window)
        assert zero.dtype == qdt and not zero.any()
        one = fref.decode_attention_ordered(q, k, v, kv_len=1,
                                            window=window)
        want = v[:, :, :1].float().repeat_interleave(2, dim=1).to(qdt)
        assert torch.equal(one, want)


# ----------------------------------------------------------- the wrapper --

class _FakeLib:
    """Records ``decode_attention_launch``'s arguments; returns 0."""

    def __init__(self):
        self.calls = []

    def decode_attention_launch(self, *args):
        self.calls.append(args)
        return 0

    def kernel_error_string(self, err):
        return b"invalid argument"


@pytest.mark.parametrize("kv_len", ["vector", 5, None])
def test_wrapper_passes_no_scratch(monkeypatch, kv_len):
    """Off the CPU (``meta`` tensors, a fake library) the wrapper makes
    one launch with q, k, v, out and the lengths (or null), then the
    scalar length, B, Hq, Hkv, S, D, window, scale, dtypes and stream: no
    scratch; the only tensor it allocates is the output, one
    ``empty_like(q)``."""
    lib = _FakeLib()
    monkeypatch.setattr(fk, "_decode_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    q = torch.empty((3, 40, 1, 128), dtype=BF16, device="meta")
    cache = torch.empty((3, 8, 544, 128), dtype=BF16, device="meta")
    lens = (torch.empty(3, dtype=torch.int64, device="meta")
            if kv_len == "vector" else kv_len)
    made = []
    empty_like = torch.empty_like

    def count_like(t, *a, **kw):
        made.append(tuple(t.shape))
        return empty_like(t, *a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("the wrapper allocated a scratch tensor")

    for name in ("empty", "zeros", "full", "empty_strided"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch, "empty_like", count_like)
    before = fk.decode_attention.launches
    out = fk.decode_attention(q, cache, cache, kv_len=lens, window=300)
    assert out.shape == q.shape and out.dtype == BF16
    assert made == [tuple(q.shape)]
    assert fk.decode_attention.launches == before + 1
    (call,) = lib.calls
    assert len(call) == 16
    assert (call[4] is None) == (kv_len != "vector")
    scalar = {"vector": 544, 5: 5, None: 544}[kv_len]
    assert call[5:12] == (scalar, 3, 40, 8, 544, 128, 300)
    assert call[12] == pytest.approx(128 ** -0.5)
    assert call[13:] == (1, 1, 7)


# -------------------------------------------------------- the split mode --

def _split(q, k, v, kv, window, n, ordered=False):
    """D1's split mode over ``n`` equal shards of the cache: each shard's
    max, their largest, each shard's partials against it, merged in rank
    order.  Returns (out, [max a shard], [(acc, l) a shard])."""
    mx, part = ((fref.decode_split_max_ordered,
                 fref.decode_split_partial_ordered) if ordered else
                (fref.decode_split_max_ref, fref.decode_split_partial_ref))
    w = k.shape[2] // n
    shards = [(k[:, :, i * w:(i + 1) * w], v[:, :, i * w:(i + 1) * w], i * w)
              for i in range(n)]
    ms = [mx(q, ks, kv_len=kv, window=window, offset=o)
          for ks, _, o in shards]
    m = torch.stack(ms).amax(0)
    parts = [part(q, ks, vs, m, kv_len=kv, window=window, offset=o)
             for ks, vs, o in shards]
    out = fref.decode_merge(torch.stack([a for a, _ in parts]),
                            torch.stack([l for _, l in parts]), q.dtype)
    return out, ms, parts


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("qdt,cdt", PAIRS)
def test_split_merged_matches_one_shot(qdt, cdt, window, n, ordered):
    """GQA 10/2, D 64, 8 rows of a 600-position cache at :data:`LENS`
    (rows whose visible positions lie in one shard, several, or all),
    split into ``n`` shards: the plain split mode (and its emulated
    order) merged in rank order within :func:`_ulp_tol` of the one-shot
    plain version (the same p, rounded alike; only the sums over shards
    in another order)."""
    q, k, v = _inputs(8, len(LENS), 10, 2, S, 64)
    kv = torch.tensor(LENS)
    args = (_t(q, qdt), _t(k, cdt), _t(v, cdt))
    want = fref.decode_attention_ref(*args, kv_len=kv, window=window)
    got, _, _ = _split(*args, kv, window, n, ordered)
    assert got.dtype == qdt and not got.isnan().any()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= _ulp_tol(want.float().numpy(), qdt, cdt), err


@pytest.mark.parametrize("ordered", [False, True])
@pytest.mark.parametrize("kv_len,window", [(10, None), (600, 7), (1, 300)])
def test_split_shard_with_nothing_visible(kv_len, window, ordered):
    """A shard that holds none of a row's visible positions (past its
    length, or before its window) gives m = -inf, l = 0 and acc = 0, and
    the merge has no NaN and equals the one-shot plain version within
    :func:`_ulp_tol`."""
    q, k, v = (_t(a, BF16) for a in _inputs(9, 2, 4, 2, S, 16))
    kv = torch.full((2,), kv_len)
    got, ms, parts = _split(q, k, v, kv, window, 2, ordered)
    empty = 1 if kv_len <= S // 2 else 0
    assert torch.equal(ms[empty], torch.full((2, 4), -torch.inf))
    acc, l = parts[empty]
    assert not acc.any() and not l.any()
    want = fref.decode_attention_ref(q, k, v, kv_len=kv, window=window)
    assert not got.isnan().any()
    assert (got.float() - want.float()).abs().max().item() <= _ulp_tol(
        want.float().numpy(), BF16)


@pytest.mark.parametrize("window", WINDOWS)
def test_split_order_rows_do_not_depend_on_the_batch(window):
    """The emulated split order of rows 0-3 of B 4 (one of 2 shards at
    offset 300) ``torch.equal`` to each row alone at B 1: the max and the
    partials."""
    q, k, v = (_t(a, BF16) for a in _inputs(10, 4, 8, 2, S, 64))
    kv = torch.tensor((600, 301, 299, 450))
    ks, vs = k[:, :, 300:], v[:, :, 300:]
    kw = dict(window=window, offset=300)
    m = fref.decode_split_max_ordered(q, ks, kv_len=kv, **kw)
    acc, l = fref.decode_split_partial_ordered(q, ks, vs, m, kv_len=kv,
                                               **kw)
    for i in range(4):
        r = slice(i, i + 1)
        mi = fref.decode_split_max_ordered(q[r], ks[r], kv_len=kv[r], **kw)
        ai, li = fref.decode_split_partial_ordered(q[r], ks[r], vs[r], m[r],
                                                   kv_len=kv[r], **kw)
        assert torch.equal(mi, m[r]) and torch.equal(ai, acc[r]) \
            and torch.equal(li, l[r]), i


def _c_params(name: str) -> list:
    """The ctypes kinds of a C entry point's parameters in the source."""
    import re
    src = open(os.path.join(os.path.dirname(fk.__file__), "csrc",
                            "decode_attention.cu")).read()
    sig = re.search(rf"int {name}\(([^)]*)\)", src).group(1)
    kinds = []
    for p in (p.strip() for p in sig.split(",")):
        kinds.append(fk._P if "*" in p else fk._F if p.startswith("float")
                     else fk._I)
    return kinds


def test_split_bindings_match_the_source():
    """Each of D1's three C entry points takes the argument kinds the
    wrapper binds (pointers, ints, the float scale), in order."""
    for name, argtypes in fk._DECODE_ARGTYPES.items():
        assert _c_params(name) == argtypes, name


@pytest.mark.parametrize("which", ["max", "partial"])
def test_split_wrappers_launch_once(monkeypatch, which):
    """Off the CPU (``meta`` tensors, a fake library) each split wrapper
    makes one launch with as many arguments as its binding, the offset
    after the window, and counts it; it refuses no ``kv_len`` and a
    negative offset before any launch."""
    lib = _FakeLib()
    calls = []
    setattr(lib, f"decode_attention_{which}_launch",
            lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(fk, "_decode_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))
    q = torch.empty((3, 40, 1, 128), dtype=BF16, device="meta")
    cache = torch.empty((3, 8, 272, 128), dtype=BF16, device="meta")
    m = torch.empty((3, 40), dtype=F32, device="meta")
    fn = getattr(fk, f"decode_attention_{which}")
    args = (q, cache) if which == "max" else (q, cache, cache, m)
    before = fn.launches
    out = fn(*args, kv_len=500, window=300, offset=272)
    assert fn.launches == before + 1
    (call,) = calls
    assert len(call) == len(fk._DECODE_ARGTYPES[
        f"decode_attention_{which}_launch"])
    tail = call[-12:]
    assert tail[:8] == (500, 3, 40, 8, 272, 128, 300, 272)
    shapes = ([tuple(out.shape)] if which == "max"
              else [tuple(t.shape) for t in out])
    assert shapes == ([(3, 40)] if which == "max"
                      else [(3, 40, 128), (3, 40)])
    for bad in (dict(kv_len=None, offset=0), dict(kv_len=5, offset=-1)):
        with pytest.raises(ValueError, match="split mode"):
            fn(*args, window=None, **bad)
    assert len(calls) == 1
