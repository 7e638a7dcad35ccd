"""Port vs reference: SpMSpM over padded-ELL streams (K5 ``spmspm_ell``)
and its host helpers.

The reference runs its Pallas kernel in interpret mode, the port its plain
version on CPU tensors.  Both add ``a * b`` for each key match in A's ``la``
order (ascending keys), product then sum each rounded in f32, so the results
must be EQUAL.  The densify-and-matmul oracle sums in another order and is
compared within atol = rtol = 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import INVALID_KEY, random_dense_sparse
from repro.kernels import tuning as r_tuning
from repro.kernels.spmspm import ops as r_ops
from repro.kernels.spmspm import ref as r_ref

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
    y = kernel.spmspm_ell(ak, av, bk, bv, rt=3, ct=64, nt=5, kt=64)
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
