"""Port vs reference: BlockQuant (per-block / per-row / per-slice scaled
fp8 e4m3, fp8 e5m2 and int8) and the quantized kernels' laws.

* With nearest rounding, and with stochastic rounding fed the reference's
  own noise (``noise=``), the quantized bytes and the scales must EQUAL the
  reference's (compared through uint8 views).
* The quantized SpMM (K2q) and SpMSpM (K5 with ``a_scales``) match the
  reference's Pallas kernels in interpret mode within 1e-5 (f32 block
  products may sum in another order; SpMSpM sums in the same order and
  must be equal).
* Inside the port, in-kernel dequantization equals dequantizing on the
  host, as ``torch.equal`` -- the laws the CUDA kernels keep on the card
  (``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import precision as rp
from repro.kernels.spmm import ops as r_spmm
from repro.kernels.spmspm import ops as r_spmspm

from repro_torch.core import precision as pp
from repro_torch.interop import bcsr_from_jax, quant_tensor_from_jax, \
    to_tensor
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmspm import ops as spmspm_ops

torch.set_num_threads(2)
QUANT = ["fp8_e4m3", "fp8_e5m2", "int8"]
TOL = dict(atol=1e-5, rtol=1e-5)


def _bytes_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == to_tensor(want).dtype
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                  want.view(np.uint8))


def _values(rng, shape):
    """Normal values over a wide range of magnitudes, with an all-zero
    block / row / slice at index 0 (scale 1.0)."""
    x = rng.standard_normal(shape) * np.exp(rng.uniform(-6, 6, shape))
    x[0] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("name", QUANT)
def test_quantize_nearest_bytes_and_scales_equal(name):
    rng = np.random.default_rng(1)
    blocks = _values(rng, (6, 8, 8))
    qw, sw = rp.quantize_blocks(jnp.asarray(blocks), name)
    qg, sg = pp.quantize_blocks(torch.from_numpy(blocks), name)
    _bytes_equal(qg, qw)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(pp.dequantize_blocks(qg, sg).numpy(),
                                  np.asarray(rp.dequantize_blocks(qw, sw)))
    rows = _values(rng, (9, 33))
    qw, sw = rp.quantize_rows(jnp.asarray(rows), name)
    qg, sg = pp.quantize_rows(torch.from_numpy(rows), name)
    _bytes_equal(qg, qw)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))
    np.testing.assert_array_equal(
        pp.dequantize_rows(qg, sg, torch.bfloat16).float().numpy(),
        np.asarray(rp.dequantize_rows(qw, sw, jnp.bfloat16), np.float32))
    x = _values(rng, (4, 5, 16))
    for axis in (-1, 0, 1):
        tw = rp.quantize_tensor(jnp.asarray(x), name, axis=axis)
        tg = pp.quantize_tensor(torch.from_numpy(x), name, axis=axis)
        _bytes_equal(tg.values, tw.values)
        np.testing.assert_array_equal(tg.scales.numpy(), np.asarray(tw.scales))
        assert tg.axis == tw.axis and tg.shape == tw.shape
        np.testing.assert_array_equal(tg.dequantize().numpy(),
                                      np.asarray(tw.dequantize()))
        crossed = quant_tensor_from_jax(tw, device="cpu")
        assert torch.equal(crossed.values.view(torch.uint8),
                           tg.values.view(torch.uint8))


def _ref_noise(name, shape, seed, salt=0):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    if name == "int8":
        return np.asarray(jax.random.uniform(key, shape, jnp.float32))
    return np.asarray(jax.random.bits(key, shape, jnp.uint32))


@pytest.mark.parametrize("name", QUANT)
def test_quantize_stochastic_with_reference_noise_equal(name):
    """Fed the reference's own random bits, stochastic rounding gives the
    reference's bytes; without them it is deterministic in the seed."""
    rng = np.random.default_rng(2)
    blocks = _values(rng, (5, 8, 8))
    qw, sw = rp.quantize_blocks(jnp.asarray(blocks), name,
                                rounding="stochastic", seed=11)
    qg, sg = pp.quantize_blocks(torch.from_numpy(blocks), name,
                                rounding="stochastic",
                                noise=_ref_noise(name, blocks.shape, 11))
    _bytes_equal(qg, qw)
    np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))
    x = (rng.standard_normal(256) * 3).astype(np.float32)
    want = rp.stochastic_round(jnp.asarray(x), name, seed=5, salt=3)
    got = pp.stochastic_round(torch.from_numpy(x), name,
                              noise=torch.from_numpy(
                                  _ref_noise(name, x.shape, 5, 3).copy()))
    _bytes_equal(got, want)
    a = pp.stochastic_round(torch.from_numpy(x), name, seed=5)
    b = pp.stochastic_round(torch.from_numpy(x), name, seed=5)
    c = pp.stochastic_round(torch.from_numpy(x), name, seed=6)
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert not torch.equal(a.view(torch.uint8), c.view(torch.uint8))


def test_saturate_and_nonfinite_guard():
    """Non-finite input raises unless ``saturate=True``, which clamps
    (NaN -> 0, Inf -> +/-3e38) exactly as the reference does."""
    x = np.array([[1.0, np.nan, np.inf], [-np.inf, 2.0, -3.0]], np.float32)
    for fn in ("quantize_rows", "quantize_tensor"):
        with pytest.raises(FloatingPointError):
            getattr(pp, fn)(torch.from_numpy(x), "fp8_e4m3")
        for name in QUANT:
            want = getattr(rp, fn)(jnp.asarray(x), name, saturate=True)
            got = getattr(pp, fn)(torch.from_numpy(x), name, saturate=True)
            qw, sw = (want.values, want.scales) if fn == "quantize_tensor" \
                else want
            qg, sg = (got.values, got.scales) if fn == "quantize_tensor" \
                else got
            _bytes_equal(qg, qw)
            np.testing.assert_array_equal(sg.numpy(), np.asarray(sw))
            assert bool(torch.isfinite(sg).all())
    with pytest.raises(FloatingPointError):
        pp.quantize_blocks(torch.from_numpy(x.reshape(1, 2, 3)), "int8")
    with pytest.raises(ValueError):
        pp.quantize_rows(torch.ones(2, 2), "fp4")


def test_ladder_names_and_widening_dot():
    assert set(pp.LADDER) == set(rp.LADDER)
    for name in QUANT:
        dt = pp.QUANT_DTYPES[name]
        assert pp.quant_name(dt) == name and pp.is_narrow(dt)
        assert pp.QUANT_MAX[name] == rp.QUANT_MAX[name]
    assert not pp.is_narrow(torch.bfloat16) and pp.quant_name(
        torch.float32) is None
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((4, 16)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        pp.widening_sum_dot(torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16()).numpy(),
        np.asarray(rp.widening_sum_dot(jnp.asarray(a, jnp.bfloat16),
                                       jnp.asarray(b, jnp.bfloat16))),
        rtol=1e-6, atol=1e-6)


def _block_sparse(rng, shape, density, block=(8, 8)):
    gm, gn = shape[0] // block[0], shape[1] // block[1]
    mask = np.kron(rng.random((gm, gn)) < density, np.ones(block, bool))
    return np.where(mask, rng.standard_normal(shape), 0).astype(np.float32)


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("N", [128, 130])
def test_spmm_quant_matches_reference_and_host_dequant(name, N):
    """K2q through ``spmm``: the reference's quantized container crosses
    with ``bcsr_from_jax``; the port agrees with the reference's quantized
    Pallas kernel within 1e-5 and equals its own f32 path on the
    host-dequantized blocks."""
    rng = np.random.default_rng(4)
    aq = rf.bcsr_from_dense(_block_sparse(rng, (64, 64), 0.2), (8, 8)
                            ).quantize(name)
    b = rng.standard_normal((64, N)).astype(np.float32)
    want = np.asarray(r_spmm.spmm(aq, jnp.asarray(b), interpret=True))
    pa = bcsr_from_jax(aq, device="cpu")
    got = spmm_ops.spmm(pa, torch.from_numpy(b), nt=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, spmm_ops.spmm(pa.dequantize(),
                                          torch.from_numpy(b)))
    batch = rf.batched_bcsr_from_dense(np.stack(
        [_block_sparse(rng, (64, 64), 0.2) for _ in range(2)]),
        (8, 8)).quantize(name)
    pb = bcsr_from_jax(batch, device="cpu")
    bb = rng.standard_normal((2, 64, N)).astype(np.float32)
    np.testing.assert_allclose(
        spmm_ops.spmm_batched(pb, torch.from_numpy(bb)).numpy(),
        np.asarray(r_spmm.spmm_batched(batch, jnp.asarray(bb),
                                       interpret=True)), **TOL)
    assert torch.equal(spmm_ops.spmm_batched(pb, torch.from_numpy(bb)),
                       spmm_ops.spmm_batched(pb.dequantize(),
                                             torch.from_numpy(bb)))
    assert spmm_ops.flops(pa, N) == r_spmm.flops(aq, N)
    assert spmm_ops.flops(pb, N) == r_spmm.flops(batch, N)


@pytest.mark.parametrize("name", QUANT)
def test_spmspm_quant_matches_reference_and_host_dequant(name):
    """K5 with per-row ``a_scales``: equal to the reference's quantized
    Pallas kernel (same sums in the same key order) and to the port's own
    f32 path on host-dequantized rows."""
    rng = np.random.default_rng(5)
    ad = rf.random_dense_sparse(rng, (20, 64), 0.2)
    bd = rf.random_dense_sparse(rng, (64, 13), 0.2)
    ak, av = r_spmspm.dense_to_ell_rows(ad)
    bk, bv = r_spmspm.dense_to_ell_cols(bd)
    qv, qs = rp.quantize_rows(jnp.asarray(av), name)
    want = np.asarray(r_spmspm.spmspm(ak, qv, bk, bv, interpret=True,
                                      a_scales=qs))
    pk, pv = spmspm_ops.dense_to_ell_rows(ad, device="cpu")
    pbk, pbv = spmspm_ops.dense_to_ell_cols(bd, device="cpu")
    pq, ps = pp.quantize_rows(pv, name)
    _bytes_equal(pq, qv)
    got = spmspm_ops.spmspm(pk, pq, pbk, pbv, a_scales=ps)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, spmspm_ops.spmspm(
        pk, pp.dequantize_rows(pq, ps), pbk, pbv))
