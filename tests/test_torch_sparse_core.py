"""Port vs reference: the sparse library's core -- containers, converters,
generators, stencil specs, SU stream ops and stream descriptors.

Inputs come from a numpy seed and go through the reference (JAX on the CPU)
and the port (CPU tensors).  Everything here is index arithmetic, copies or
the same f32 operations in the same order, so results must be equal; the
one sum whose order differs (``intersect_dot``) is compared within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as rf
from repro.core import stencils as rs
from repro.core import streams as rstr
from repro.core import su as rsu

from repro_torch import core
from repro_torch.core import formats as pf
from repro_torch.core import stencils as ps
from repro_torch.core import streams as pstr
from repro_torch.core import su as psu
from repro_torch.interop import bcsr_from_jax, to_tensor
from repro_torch.kernels.spmspm import ops as spmspm_ops

torch.set_num_threads(2)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_generators_give_the_reference_matrices(seed):
    """One numpy seed gives the same matrix on both sides."""
    for name, args in (("random_dense_sparse", ((24, 40), 0.2)),
                       ("banded_sparse", ((24, 40), 3)),
                       ("powerlaw_sparse", ((24, 40), 0.1)),
                       ("block_sparse_mask", ((6, 5), 0.4))):
        want = getattr(rf, name)(np.random.default_rng(seed), *args)
        got = getattr(pf, name)(np.random.default_rng(seed), *args)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("block", [(8, 8), (8, 16)])
def test_converters_and_containers_match_reference(block):
    rng = np.random.default_rng(3)
    dense = rf.random_dense_sparse(rng, (48, 64), 0.1)
    dense[8:16] = 0.0                                  # an empty block-row
    want = rf.bcsr_from_dense(dense, block)
    got = pf.bcsr_from_dense(dense, block, device="cpu")
    for f in ("indptr", "block_rows", "block_cols", "blocks"):
        _eq(getattr(got, f), getattr(want, f))
    assert (got.nnzb, got.grid_shape, got.density()) == \
        (want.nnzb, want.grid_shape, want.density())
    _eq(got.todense(), want.todense())
    stack = np.stack([dense, rf.random_dense_sparse(rng, (48, 64), 0.1)])
    bw, bg = (rf.batched_bcsr_from_dense(stack, block),
              pf.batched_bcsr_from_dense(stack, block, device="cpu"))
    for f in ("indptr", "block_rows", "block_cols", "blocks"):
        _eq(getattr(bg, f), getattr(bw, f))
    _eq(bg.todense(), bw.todense())
    _eq(bg[1].todense(), bw[1].todense())
    cw, cg = rf.csr_from_dense(dense), pf.csr_from_dense(dense, device="cpu")
    for f in ("indptr", "indices", "values"):
        _eq(getattr(cg, f), getattr(cw, f))
    _eq(cg.todense(), cw.todense())
    ow = rf.coo_from_dense(dense, 400)
    og = pf.coo_from_dense(dense, 400, device="cpu")
    for f in ("keys", "values", "count"):
        _eq(getattr(og, f), getattr(ow, f))
    _eq(og.todense(), ow.todense())
    assert og.capacity == ow.capacity == 400


@pytest.mark.parametrize("name", ["fp8_e4m3", "fp8_e5m2", "int8"])
def test_quantized_containers_match_reference(name):
    """quantize / dequantize / todense of BCSR and BatchedBCSR give the
    reference's bytes, scales and values; a reference container crosses
    through ``bcsr_from_jax`` intact."""
    rng = np.random.default_rng(4)
    dense = np.stack([rf.random_dense_sparse(rng, (32, 48), 0.3)
                      for _ in range(2)])
    for want, got in ((rf.bcsr_from_dense(dense[0], (8, 8)).quantize(name),
                       pf.bcsr_from_dense(dense[0], (8, 8),
                                          device="cpu").quantize(name)),
                      (rf.batched_bcsr_from_dense(dense, (8, 8)).quantize(
                          name), pf.batched_bcsr_from_dense(
                              dense, (8, 8), device="cpu").quantize(name))):
        _eq(got.blocks.view(torch.uint8),
            np.asarray(want.blocks).view(np.uint8))
        _eq(got.scales, want.scales)
        _eq(got.dequantize().blocks, want.dequantize().blocks)
        _eq(got.todense(), want.todense())
        crossed = bcsr_from_jax(want, device="cpu")
        assert torch.equal(crossed.blocks.view(torch.uint8),
                           got.blocks.view(torch.uint8))
        assert torch.equal(crossed.scales, got.scales)


_CONVERTERS = {
    "bcsr_from_dense": lambda d, **kw: pf.bcsr_from_dense(d, (8, 8),
                                                          **kw).blocks,
    "batched_bcsr_from_dense": lambda d, **kw: pf.batched_bcsr_from_dense(
        d[None], (8, 8), **kw).blocks,
    "csr_from_dense": lambda d, **kw: pf.csr_from_dense(d, **kw).values,
    "coo_from_dense": lambda d, **kw: pf.coo_from_dense(d, **kw).keys,
    "dense_to_ell_rows": lambda d, **kw: spmspm_ops.dense_to_ell_rows(
        d, **kw)[0],
    "dense_to_ell_cols": lambda d, **kw: spmspm_ops.dense_to_ell_cols(
        d, **kw)[0],
}


@pytest.mark.parametrize("name", list(_CONVERTERS))
def test_converters_send_numpy_to_the_card_by_default(name):
    """Numpy input goes to ``device``, the card by default (which raises
    without a GPU); a tensor stays where it lies."""
    fn = _CONVERTERS[name]
    dense = rf.random_dense_sparse(np.random.default_rng(6), (16, 16), 0.3)
    if torch.cuda.is_available():
        assert fn(dense).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(dense)
    assert fn(dense, device="cpu").device.type == "cpu"
    assert fn(torch.from_numpy(dense)).device.type == "cpu"


def test_container_guards():
    rng = np.random.default_rng(5)
    a = pf.bcsr_from_dense(rf.random_dense_sparse(rng, (32, 32), 0.3), (8, 8),
                           device="cpu")
    aq = a.quantize("int8")
    kw = dict(indptr=a.indptr, block_rows=a.block_rows,
              block_cols=a.block_cols, shape=a.shape, block=a.block)
    with pytest.raises(ValueError, match="scales"):
        pf.BCSR(blocks=a.blocks.to(torch.float8_e4m3fn), **kw)
    with pytest.raises(ValueError, match=str(tuple(aq.blocks.shape[:1]))):
        pf.BCSR(blocks=aq.blocks, scales=aq.scales[:-1], **kw)
    with pytest.raises(ValueError, match="float32"):
        pf.BCSR(blocks=aq.blocks, scales=aq.scales.half(), **kw)


def test_stencil_specs_equal_reference():
    """Same taps, the same coefficient doubles, the same derived sizes."""
    assert list(ps.STENCILS) == list(rs.STENCILS)
    for name, want in rs.STENCILS.items():
        got = ps.STENCILS[name]
        assert (got.ndim, got.offsets, got.coeffs) == \
            (want.ndim, want.offsets, want.coeffs)
        assert (got.points, got.radius, got.flops_per_point()) == \
            (want.points, want.radius, want.flops_per_point())


@pytest.mark.parametrize("name", list(rs.STENCILS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_plain_equals_reference_oracle(name, dtype):
    """The shifted-slice oracle and the gather baseline equal the
    reference's bit for bit: f32 coefficient times tap, then add, in the
    same order."""
    spec = rs.STENCILS[name]
    shape = (19, 37) if spec.ndim == 2 else (5, 7, 11)
    r = spec.radius
    g = np.random.default_rng(6).standard_normal(
        tuple(s + 2 * r for s in shape)).astype(np.float32)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    pg = to_tensor(np.asarray(jg))
    for rfn, pfn in ((rs.apply_reference, ps.apply_reference),
                     (rs.apply_gather_baseline, ps.apply_gather_baseline)):
        want = np.asarray(rfn(spec, jg).astype(jnp.float32))
        got = pfn(ps.STENCILS[name], pg)
        assert got.dtype == pg.dtype
        np.testing.assert_array_equal(got.float().numpy(), want)


def _keys(rng, n, pad, hi=1000):
    k = np.sort(rng.choice(hi, n, replace=False)).astype(np.int32)
    return np.pad(k, (0, pad), constant_values=rf.INVALID_KEY)


def test_su_intersect_union_match_reference():
    rng = np.random.default_rng(7)
    ka, kb = _keys(rng, 64, 64), _keys(rng, 96, 32)
    va = rng.standard_normal(128).astype(np.float32)
    vb = rng.standard_normal(128).astype(np.float32)
    want = rsu.intersect(jnp.asarray(ka), jnp.asarray(kb))
    got = psu.intersect(torch.from_numpy(ka), torch.from_numpy(kb))
    for f in want._fields:
        _eq(getattr(got, f), getattr(want, f))
    assert int(got.count) == len(np.intersect1d(ka[:64], kb[:96]))
    np.testing.assert_allclose(
        float(psu.intersect_dot(*map(torch.from_numpy, (ka, va, kb, vb)))),
        float(rsu.intersect_dot(*map(jnp.asarray, (ka, va, kb, vb)))),
        rtol=1e-6)
    uw = rsu.union_add(*map(jnp.asarray, (ka, va, kb, vb)))
    ug = psu.union_add(*map(torch.from_numpy, (ka, va, kb, vb)))
    for f in uw._fields:
        _eq(getattr(ug, f), getattr(uw, f))


def test_su_topk_densify_indirect_match_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((16, 32)).astype(np.float32)
    kw, vw = rsu.topk_sparsify(jnp.asarray(x), 40)
    kg, vg = psu.topk_sparsify(torch.from_numpy(x), 40)
    _eq(kg, kw)
    _eq(vg, vw)
    cnt = np.int32(31)
    _eq(psu.stream_densify(kg, vg, torch.tensor(cnt), 512),
        rsu.stream_densify(kw, vw, jnp.asarray(cnt), 512))
    data = rng.standard_normal((50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, 20).astype(np.int16)
    _eq(psu.indirect_gather(torch.from_numpy(data), torch.from_numpy(idx)),
        rsu.indirect_gather(jnp.asarray(data), jnp.asarray(idx)))
    vals = rng.standard_normal((20, 3)).astype(np.float32)
    _eq(psu.indirect_scatter_add(torch.from_numpy(data),
                                 torch.from_numpy(idx),
                                 torch.from_numpy(vals)),
        rsu.indirect_scatter_add(jnp.asarray(data), jnp.asarray(idx),
                                 jnp.asarray(vals)))


def test_streams_match_reference():
    flat = np.arange(4 * 6 * 5, dtype=np.float32)
    for order in (None, (2, 0, 1)):
        want = rstr.StreamSpec.for_tensor((4, 6, 5), order)
        got = pstr.StreamSpec.for_tensor((4, 6, 5), order)
        assert (got.base, got.bounds, got.strides, got.length) == \
            (want.base, want.bounds, want.strides, want.length)
        np.testing.assert_array_equal(got.offsets(), want.offsets())
        _eq(got.read(torch.from_numpy(flat)), want.read(jnp.asarray(flat)))
    idx = np.array([3, 1, 3, 7], np.int32)
    vals = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    ws, gs = rstr.IndirectStream(jnp.asarray(idx), 2, 5), \
        pstr.IndirectStream(torch.from_numpy(idx), 2, 5)
    _eq(gs.read(torch.from_numpy(flat)), ws.read(jnp.asarray(flat)))
    _eq(gs.write(torch.from_numpy(flat), torch.from_numpy(vals)),
        ws.write(jnp.asarray(flat), jnp.asarray(vals)))
    uniq = pstr.IndirectStream(torch.tensor([0, 2, 4]))
    _eq(uniq.write(torch.from_numpy(flat), torch.ones(3), accumulate=False),
        rstr.IndirectStream(jnp.asarray([0, 2, 4])).write(
            jnp.asarray(flat), jnp.ones(3), accumulate=False))
    with pytest.raises(ValueError):
        pstr.StreamSpec(0, (1, 1, 1, 1, 1), (1, 1, 1, 1, 1))


def test_core_exports_follow_the_reference():
    import repro.core as rcore
    assert set(core.__all__) == set(rcore.__all__)
