"""Port vs reference: SpMSpM over padded-ELL streams (K5 ``spmspm_ell``)
and its host helpers.

The reference runs its Pallas kernel in interpret mode, the port its plain
version on CPU tensors.  Both add ``a * b`` for each key match in A's ``la``
order (ascending keys), product then sum each rounded in f32, so the results
must be EQUAL.  The densify-and-matmul oracle sums in another order and is
compared within atol = rtol = 1e-5.

The CUDA kernel cannot run here, so its traversal is pinned by an
emulation in plain torch (:func:`_emulate_kernel`): B bucketed by (key,
slab) in an arbitrary order inside each bucket, each (row, slab) walking
its row's keys in stream order with one rounded product and one rounded add
per match.  It must EQUAL the plain version and the reference.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as rp
from repro.core.formats import INVALID_KEY, random_dense_sparse
from repro.kernels import tuning as r_tuning
from repro.kernels.spmspm import ops as r_ops
from repro.kernels.spmspm import ref as r_ref

from repro_torch import to_tensor
from repro_torch.kernels import tuning
from repro_torch.kernels.spmspm import kernel, ops, ref

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _streams(seed, shape, a_density, b_density):
    rng = np.random.default_rng(seed)
    R, K, C = shape
    return (random_dense_sparse(rng, (R, K), a_density),
            random_dense_sparse(rng, (K, C), b_density))


@pytest.mark.parametrize("density", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("shape", [(16, 64, 16), (32, 128, 24), (20, 96, 13)])
def test_spmspm_matches_reference(density, shape):
    """Dense results equal the reference's, ragged R and C included, and
    agree with the oracle."""
    a, b = _streams(11, shape, 0.3, density)
    ak, av = r_ops.dense_to_ell_rows(a)
    bk, bv = r_ops.dense_to_ell_cols(b)
    want = np.asarray(r_ops.spmspm(ak, av, bk, bv, rt=8, ct=8,
                                   interpret=True))
    pak, pav = ops.dense_to_ell_rows(a, device="cpu")
    pbk, pbv = ops.dense_to_ell_cols(b, device="cpu")
    got = ops.spmspm(pak, pav, pbk, pbv, rt=8, ct=8, nt=2)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(r_ref.spmspm_ref(ak, av, bk, bv, shape[1])),
        **TOL)
    np.testing.assert_allclose(
        ref.spmspm_ref(pak, pav, pbk, pbv, shape[1]).numpy(),
        np.asarray(r_ref.spmspm_ref(ak, av, bk, bv, shape[1])), **TOL)


def test_spmspm_bf16_values_and_numpy_inputs():
    """bf16 values widen exactly on both sides; numpy streams go to the
    device asked for."""
    a, b = _streams(12, (16, 64, 16), 0.3, 0.2)
    ak, av = r_ops.dense_to_ell_rows(a)
    bk, bv = r_ops.dense_to_ell_cols(b)
    av16, bv16 = jnp.asarray(av, jnp.bfloat16), jnp.asarray(bv, jnp.bfloat16)
    want = np.asarray(r_ops.spmspm(ak, av16, bk, bv16, interpret=True))
    got = ops.spmspm(ak, np.asarray(av16), bk, np.asarray(bv16),
                     device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_nonmatching_inf_contributes_nothing():
    """An Inf in B whose key A lacks gives no NaN (no 0 * b term)."""
    a = np.zeros((8, 16), np.float32)
    a[:, 2] = 1.0
    b = np.zeros((16, 8), np.float32)
    b[5, :] = np.inf
    b[2, :] = 3.0
    ak, av = ops.dense_to_ell_rows(a, device="cpu")
    bk, bv = ops.dense_to_ell_cols(b, device="cpu")
    got = ops.spmspm(ak, av, bk, bv)
    assert torch.equal(got, torch.full((8, 8), 3.0))
    want = np.asarray(r_ops.spmspm(*r_ops.dense_to_ell_rows(a),
                                   *r_ops.dense_to_ell_cols(b),
                                   interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ell_converters_stats_and_compaction_match_reference():
    a, b = _streams(13, (24, 80, 20), 0.2, 0.1)
    for width in (None, 40):
        for rfn, pfn, m in ((r_ops.dense_to_ell_rows, ops.dense_to_ell_rows,
                             a),
                            (r_ops.dense_to_ell_cols, ops.dense_to_ell_cols,
                             b)):
            wk, wv = rfn(m, width)
            gk, gv = pfn(m, width, device="cpu")
            np.testing.assert_array_equal(gk.numpy(), wk)
            np.testing.assert_array_equal(gv.numpy(), wv)
            np.testing.assert_array_equal(
                ref.ell_to_dense(gk, gv, m.shape[1] if pfn is
                                 ops.dense_to_ell_rows else m.shape[0]
                                 ).numpy(),
                r_ref.ell_to_dense(wk, wv, m.shape[1] if pfn is
                                   ops.dense_to_ell_rows else m.shape[0]))
    with pytest.raises(ValueError):
        ops.dense_to_ell_rows(a, 1, device="cpu")
    ak, av = r_ops.dense_to_ell_rows(a)
    bk, bv = r_ops.dense_to_ell_cols(b)
    assert ops.comparison_stats(torch.from_numpy(ak),
                                torch.from_numpy(bk)) == \
        ops.comparison_stats(ak, bk, device="cpu") == \
        r_ops.comparison_stats(ak, bk)
    np.testing.assert_allclose(
        ref.spmspm_gather_baseline(*map(torch.from_numpy,
                                        (ak, av, bk, bv))).numpy(),
        np.asarray(r_ref.spmspm_gather_baseline(ak, av, bk, bv)), **TOL)
    c = random_dense_sparse(np.random.default_rng(14), (8, 8), 0.3)
    for cap in (64, 10):
        wk, wv, wc = r_ops.compact_result(jnp.asarray(c), cap)
        gk, gv, gc = ops.compact_result(torch.from_numpy(c), cap)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert int(gc) == int(wc)
    assert (gk.numpy() == INVALID_KEY).sum() == 0


def test_wrapper_plain_path_and_guards():
    """CPU streams take the plain version (no launch) for any tiles; a bad
    ``nt`` or a narrow A without scales is refused."""
    a, b = _streams(15, (16, 64, 16), 0.3, 0.2)
    ak, av = ops.dense_to_ell_rows(a, device="cpu")
    bk, bv = ops.dense_to_ell_cols(b, device="cpu")
    before = kernel.spmspm_ell.launches
    x = kernel.spmspm_ell(ak, av, bk, bv)
    y = kernel.spmspm_ell(ak, av, bk, bv, rt=3, ct=64, nt=5)
    assert torch.equal(x, y) and kernel.spmspm_ell.launches == before
    with pytest.raises(ValueError):
        ops.spmspm(ak, av, bk, bv, nt=0)
    with pytest.raises(TypeError):
        kernel.spmspm_ell(ak, av, bk, bv, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_tuning_rows(dtype):
    """CPU (rt, ct) and nt equal the reference's CPU values (its sublane
    and VMEM clamps); on the card rt is at most R and nt never wider than
    the problem."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float8_e4m3fn: jnp.float8_e4m3fn}[dtype]
    for r, c, la, lb in ((16, 16, 4, 4), (20, 13, 1, 1), (3, 1000, 64, 2048),
                         (8192, 8192, 500, 125), (8, 8, 2**17, 2**17)):
        rt, ct = tuning.spmspm_tiles(r, c, la, lb, dtype)
        assert (rt, ct) == r_tuning.spmspm_tiles(r, c, la, lb, jdt)
        assert tuning.spmspm_nt(c, ct, lb, dtype) == \
            r_tuning.spmspm_nt(c, ct, lb, jdt)
        rt, ct = tuning.spmspm_tiles(r, c, la, lb, dtype, "cuda")
        nt = tuning.spmspm_nt(c, ct, lb, dtype, "cuda")
        assert 1 <= rt <= r and ct >= 1 and 1 <= nt
        assert nt == 1 or (nt - 1) * ct < c


# ---------------------------------------------------------------------------
# The CUDA kernel's order, emulated: Gustavson's row-wise product over B
# bucketed by (key, slab of ``width`` output columns).
# ---------------------------------------------------------------------------

_INV = int(INVALID_KEY)


def _emulate_kernel(ak, av, bk, bv, width, a_scales=None, seed=0):
    """``csrc/spmspm_ell.cu`` step for step in plain torch: B's valid
    entries go to bucket ``(k - kmin) * slabs + c // width`` (counted,
    scanned, then scattered in an arbitrary order, drawn from ``seed``);
    each (A row, slab) zeroes ``width`` f32 accumulators, walks its row's
    keys in stream order and, for a key inside B's range, adds the rounded
    ``a * b`` of each of the bucket's entries; then writes the slab."""
    R, La = ak.shape
    C, Lb = bk.shape
    valid = bk != _INV
    keys = bk[valid].long()
    kmin, kmax = (int(keys.min()), int(keys.max())) if keys.numel() \
        else (1, 0)
    span, slabs = kernel.bucket_geometry(kmin, kmax, C, width)
    cols = torch.arange(C)[:, None].expand(C, Lb)[valid]
    bucket = (keys - kmin) * slabs + cols // width
    counts = torch.bincount(bucket, minlength=span * slabs)
    offsets = torch.zeros(span * slabs + 1, dtype=torch.long)
    offsets[1:] = counts.cumsum(0)
    perm = torch.from_numpy(
        np.random.default_rng(seed).permutation(bucket.numel()))
    order = perm[torch.sort(bucket[perm], stable=True).indices]
    e_cols, e_vals = cols[order], bv.float()[valid][order]
    a = av.float()
    if a_scales is not None:
        a = a * a_scales.reshape(R, 1).float()
    out = torch.empty((R, C), dtype=torch.float32)
    for r in range(R):
        for s in range(slabs):
            acc = torch.zeros(width, dtype=torch.float32)
            for p in range(La):
                d = int(ak[r, p]) - kmin
                if int(ak[r, p]) == _INV or not 0 <= d < span:
                    continue
                lo, hi = offsets[d * slabs + s], offsets[d * slabs + s + 1]
                c = e_cols[lo:hi] - s * width
                acc[c] = acc[c] + a[r, p] * e_vals[lo:hi]
            w = min(width, C - s * width)
            out[r, s * width:s * width + w] = acc[:w]
    return out


def _ell(rng, n, keys, density, width):
    """``n`` ascending padded-ELL streams over the key pool ``keys``: each
    key kept with probability ``density``, N(0, 1) f32 values."""
    k = np.full((n, width), _INV, np.int32)
    v = np.zeros((n, width), np.float32)
    for i in range(n):
        row = np.sort(keys[rng.random(len(keys)) < density])[:width]
        k[i, :len(row)] = row
        v[i, :len(row)] = rng.standard_normal(len(row))
    return k, v


_CASES = ["ragged", "empty_streams", "a_keys_outside_b", "nonfinite_b",
          "explicit_zeros", "bf16_b", "fp8_a_scales"]


@functools.lru_cache(maxsize=None)
def _case(name):
    """Seeded numpy streams of one edge case (R 20, K 96, C 37: no tested
    slab width divides C), as (reference inputs, port inputs, kwargs)."""
    rng = np.random.default_rng(_CASES.index(name) + 40)
    R, K, C, La, Lb = 20, 96, 37, 40, 30
    a_pool = b_pool = np.arange(K)
    if name == "a_keys_outside_b":
        b_pool = np.arange(30, 60)      # A's keys below 30 and over 59 miss
    if name == "nonfinite_b":
        a_pool = np.arange(0, K, 2)     # A holds even keys only
    ak, av = _ell(rng, R, a_pool, 0.3, La)
    bk, bv = _ell(rng, C, b_pool, 0.2, Lb)
    if name == "empty_streams":
        ak[[0, 7]], av[[0, 7]] = _INV, 0.0
        bk[[3, 36]], bv[[3, 36]] = _INV, 0.0
    if name == "nonfinite_b":          # Inf / NaN only at odd keys
        odd = (bk != _INV) & (bk % 2 == 1)
        bv[odd] = np.where(rng.random(odd.sum()) < 0.5, np.inf, np.nan)
        bv[np.nonzero(odd)[0][:1], np.nonzero(odd)[1][:1]] = -np.inf
    if name == "explicit_zeros":       # valid keys that hold +0 or -0
        for v, k in ((av, ak), (bv, bk)):
            z = (k != _INV) & (rng.random(k.shape) < 0.3)
            v[z] = np.where(rng.random(z.sum()) < 0.5, 0.0, -0.0)
    r_in = [ak, jnp.asarray(av), bk, jnp.asarray(bv)]
    kw = {}
    if name == "bf16_b":
        r_in[3] = jnp.asarray(bv, jnp.bfloat16)
    if name == "fp8_a_scales":
        qv, qs = rp.quantize_rows(jnp.asarray(av), "fp8_e4m3")
        r_in[1] = qv
        kw["a_scales"] = qs
    p_in = [to_tensor(x) for x in r_in]
    p_kw = {k: to_tensor(v) for k, v in kw.items()}
    want = np.asarray(r_ops.spmspm(*r_in, interpret=True, **kw))
    return p_in, p_kw, want


@pytest.mark.parametrize("width", [4, 12, 64])
@pytest.mark.parametrize("name", _CASES)
def test_kernel_order_emulation_equals_plain_and_reference(name, width):
    """The kernel's traversal (bucketed B, rows in stream order) gives the
    plain version's and the reference's sums bit for bit, at slab widths
    that do not divide C (37): ragged streams, empty A rows and B columns,
    A keys outside B's key range, Inf / NaN in B at keys A lacks, explicit
    +-0 values, bf16 B and fp8 e4m3 A with row scales."""
    p_in, p_kw, want = _case(name)
    got = _emulate_kernel(*p_in, width, seed=width, **p_kw)
    plain = ref.spmspm_ell_ref(*p_in, **p_kw)
    assert torch.equal(got, plain)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(ops.spmspm(*p_in, **p_kw), plain)


def test_emulation_bucket_order_is_free():
    """Any order inside a bucket gives the same bits: one key's entries
    lie on distinct columns."""
    p_in, _, _ = _case("ragged")
    runs = [_emulate_kernel(*p_in, 12, seed=s) for s in range(3)]
    assert all(torch.equal(runs[0], x) for x in runs[1:])


def test_bucket_geometry_sizes_and_guards():
    """The table's key span and slab count, and the wrapper's guards: a
    negative key and a table over MAX_BUCKETS raise; no valid key gives an
    empty table (the product then writes zeros)."""
    assert kernel.bucket_geometry(0, 8191, 8192, 2048) == (8192, 4)
    assert kernel.bucket_geometry(5, 9, 37, 12) == (5, 4)
    assert kernel.bucket_geometry(3, 3, 1, 2048) == (1, 1)
    assert kernel.bucket_geometry(1, 0, 37, 12) == (0, 4)
    assert kernel.bucket_geometry(0x7f7f7f7f, -0x7f7f7f80, 8, 4)[0] == 0
    limit = kernel.MAX_BUCKETS
    assert kernel.bucket_geometry(0, limit // 4 - 1, 8192, 2048) == \
        (limit // 4, 4)
    with pytest.raises(ValueError, match="negative"):
        kernel.bucket_geometry(-1, 10, 8, 4)
    with pytest.raises(ValueError, match="buckets"):
        kernel.bucket_geometry(0, limit // 4, 8192, 2048)
    assert kernel.product_smem_bytes(4, 2048) == 4 * (4 * 2048 + 512)
    assert kernel.product_smem_bytes(4, 2048) <= tuning.SMEM_BUDGET
    empty = [torch.full((4, 3), _INV, dtype=torch.int32),
             torch.ones(4, 3), torch.full((5, 2), _INV, dtype=torch.int32),
             torch.ones(5, 2)]
    assert torch.equal(_emulate_kernel(*empty, 4), torch.zeros(4, 5))
    assert torch.equal(ref.spmspm_ell_ref(*empty), torch.zeros(4, 5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
def test_cuda_tiles_fit_the_kernel(dtype):
    """The cuda ``spmspm`` row at the slice's shape: W = nt * ct a multiple
    of 4, 1..32 warps a block, the block within shared memory."""
    rt, ct = tuning.spmspm_tiles(8192, 8192, 494, 121, dtype, "cuda")
    nt = tuning.spmspm_nt(8192, ct, 121, dtype, "cuda")
    assert 1 <= rt <= 32 and (nt * ct) % 4 == 0
    assert kernel.product_smem_bytes(rt, nt * ct) <= tuning.SMEM_BUDGET
