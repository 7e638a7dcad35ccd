"""The sharded engine on gloo ranks on the CPU, vs the port's one-device
kernels and vs the reference.

Two module-scoped spawns (``parallel.ranks.run_ranks``: 4 ranks and 2
ranks, one process each, a gloo group through a ``FileStore`` in a
temporary directory, a 60 s group timeout, the parent waiting at most
``LIMIT`` seconds and killing what is left) run every case once and return
each rank's results.  The cases are the reference's own, parametrised as
there (``test_sparse_engine.py``, ``test_kernels_multitile.py:104-165``,
``test_kernels_precision.py:181-245``, ``test_attention_sparse.py:243-258``),
so each counts as a test; each holds two things:

* every rank returned the same result, and it equals the port's
  one-device call on the full operands (run here, with no process group)
  as ``torch.equal`` -- the reference's law, sharded == one device;
* the port against the reference: the reference's sharded call where it
  runs on jax 0.9.0 (``sharded_ref`` in :func:`_specs`), elsewhere its one-device kernel in
  interpret mode (which that law makes the same check); within atol = rtol
  = 1e-5 (f32: the plain block product and the Pallas kernel sum in other
  orders), bit for bit for the 0/1 dispatch copy.

Also: ``sharded_flash_attention`` on a (2, 2) ("data", "model") mesh and a
(1, 2, 2) ("pod", "data", "model") mesh against the reference's K3 in
interpret mode on the whole sequence, and ``FlashFwdChunkedBwd`` under the
mesh (forward and gradients == one device); the no-group path (== the
one-device call); the refusals (a production mesh on 4 ranks, an uneven
split); a rank that raises (its traceback reaches the test within the
group timeout) and a rank that hangs (the other fails at the group timeout
and the sleeper is killed; ranks that all hang are killed at the limit).

The ranks import this file, so the reference (and JAX) is imported by the
parent only, inside :func:`_ref`.
"""
import functools
import time
import types
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import precision
from repro_torch.core.formats import (batched_bcsr_from_dense,
                                      bcsr_from_dense, powerlaw_sparse,
                                      random_dense_sparse)
from repro_torch.core.masks import BlockMask
from repro_torch.kernels import engine
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.kernels.spmspm import ops as spmspm_ops
from repro_torch.models import layers
from repro_torch.parallel.ranks import RankError, run_ranks

TOL = dict(atol=1e-5, rtol=1e-5)
GROUP_TIMEOUT = 60.0
LIMIT = 120.0
QUANT = ("fp8_e4m3", "fp8_e5m2", "int8")
ATTN_PATTERNS = ("window", "causal", "local|global")
FLASH_MESHES = {"data_model": dict(data=2, model=2),
                "pod_data_model": dict(pod=1, data=2, model=2)}


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (JAX on the CPU; conftest's 4 devices)."""
    import jax
    import jax.numpy as jnp
    from repro.core import formats, masks
    from repro.core import precision as rprecision
    from repro.kernels import engine as rengine
    from repro.kernels.flash_attention import kernel as rfk
    from repro.kernels.flash_attention import ops as rfops
    from repro.kernels.spmm import ops as rspmm
    from repro.kernels.spmspm import ops as rspmspm
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, formats=formats, masks=masks,
        precision=rprecision, engine=rengine, fk=rfk, fops=rfops,
        spmm=rspmm, spmspm=rspmspm,
        mesh=lambda n: jax.make_mesh((n,), ("data",)))


def _rng(key: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(key.encode()))


def _block_sparse(rng, shape, density, block=(8, 8)):
    gm, gn = shape[0] // block[0], shape[1] // block[1]
    mask = np.kron(rng.random((gm, gn)) < density, np.ones(block, bool))
    return np.where(mask, rng.standard_normal(shape), 0).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ----------------------------------------------------------------- cases ----
# A case: the call the ranks make (engine function name, args, kwargs, and
# the mesh: None for the automatic one, else make_host_mesh's sizes), the
# port's one-device call, the reference's result and how it is compared.

Case = types.SimpleNamespace


def _spmm_case(key, n_dev, shape, density, N, *, gen=random_dense_sparse,
               bn=None, nt=None, ref_bn=None, ref_nt=None, quant=None,
               sharded_ref=False, auto=False):
    rng = _rng(key)
    a_np = gen(rng, shape, density)
    b = rng.standard_normal((shape[1], N)).astype(np.float32)
    a = bcsr_from_dense(a_np, (8, 8), device="cpu")
    if quant:
        a = a.quantize(quant)

    def ref():
        r = _ref()
        ra = r.formats.bcsr_from_dense(a_np, (8, 8))
        if quant:
            ra = ra.quantize(quant)
        if sharded_ref:
            return r.engine.shard_spmm(ra, r.jnp.asarray(b),
                                       mesh=r.mesh(n_dev), bn=bn, nt=nt)
        if quant:
            ra = ra.dequantize()
        return r.spmm.spmm(ra, r.jnp.asarray(b), bn=ref_bn, nt=ref_nt,
                           interpret=True)

    return Case(world=n_dev, op="shard_spmm", args=(a, _t(b)),
                kwargs=dict(bn=bn, nt=nt),
                mesh=None if auto else dict(data=n_dev),
                single=lambda: spmm_ops.spmm(a, _t(b)), ref=ref, exact=False)


def _batched_case(key, n_dev, B, shape, density, N, *, broadcast=False,
                  op="shard_spmm_batched", bn=None, nt=None, quant=None,
                  gen=random_dense_sparse, sharded_ref=False, dispatch=False):
    # ``nt`` goes to the reference only: the port's batched entries take none
    rng = _rng(key)
    stack = np.stack([gen(rng, shape, density) for _ in range(B)])
    if dispatch:     # 0/1 rows, at most one 1 each: the MoE dispatch copy
        stack = np.zeros((B,) + shape, np.float32)
        for i in range(B):
            rows = rng.random(shape[0]) < 0.7
            stack[i, np.nonzero(rows)[0],
                  rng.integers(0, shape[1], rows.sum())] = 1.0
    d = rng.standard_normal(((shape[1], N) if broadcast
                             else (B, shape[1], N))).astype(np.float32)
    a = batched_bcsr_from_dense(stack, (8, 8), device="cpu")
    if quant:
        a = a.quantize(quant)
    if op == "shard_spmm_batched_stream":
        a = spmm_ops.pad_empty_rows(a)

    def ref():
        r = _ref()
        ra = r.formats.batched_bcsr_from_dense(stack, (8, 8))
        if quant:
            ra = ra.quantize(quant)
        if sharded_ref:
            if op == "shard_spmm_batched_stream":
                ra = r.spmm.pad_empty_rows(ra)
            return getattr(r.engine, op)(ra, r.jnp.asarray(d),
                                         mesh=r.mesh(n_dev), bn=bn, nt=nt)
        if quant:
            ra = ra.dequantize()
        return r.spmm.spmm_batched(ra, r.jnp.asarray(d), interpret=True)

    return Case(world=n_dev, op=op, args=(a, _t(d)), kwargs=dict(bn=bn),
                mesh=dict(data=n_dev),
                single=lambda: spmm_ops.spmm_batched(a, _t(d)), ref=ref,
                exact=dispatch)


def _spmspm_case(key, n_dev, a_shape, a_density, b_shape, b_density, *,
                 rt=None, ct=None, nt=None, quant=None, empty=False,
                 sharded_ref=False, oracle=False):
    rng = _rng(key)
    A = random_dense_sparse(rng, a_shape, a_density)
    Bm = (np.zeros(b_shape, np.float32) if empty
          else random_dense_sparse(rng, b_shape, b_density))
    ak, av = spmspm_ops.dense_to_ell_rows(A, device="cpu")
    bk, bv = spmspm_ops.dense_to_ell_cols(Bm, device="cpu")
    kw = dict(rt=rt, ct=ct, nt=nt)
    if quant:
        av, kw["a_scales"] = precision.quantize_rows(av, quant)
    args = (ak, av, bk, bv)

    def ref():
        r = _ref()
        rak, rav = r.spmspm.dense_to_ell_rows(A)
        rbk, rbv = r.spmspm.dense_to_ell_cols(Bm)
        if not quant:
            if sharded_ref:
                return r.engine.shard_spmspm(rak, rav, rbk, rbv,
                                             mesh=r.mesh(n_dev), **kw)
            return r.spmspm.spmspm(rak, rav, rbk, rbv, rt=rt, ct=ct,
                                   nt=nt if nt is None else 1, interpret=True)
        qv, qs = r.precision.quantize_rows(r.jnp.asarray(rav), quant)
        return r.engine.shard_spmspm(rak, qv, rbk, rbv, mesh=r.mesh(n_dev),
                                     a_scales=qs)

    return Case(world=n_dev, op="shard_spmspm", args=args, kwargs=kw,
                mesh=dict(data=n_dev),
                single=lambda: spmspm_ops.spmspm(*args, **kw), ref=ref,
                exact=False, oracle=(A, Bm) if oracle else None)


def _attention_case(key, pattern):
    bq = bk = 8
    S, D = 64, 16
    rng = _rng(key)
    q, k, v = (rng.standard_normal((1, 2, S, D)).astype(np.float32)
               for _ in range(3))

    def masks(M):
        local = M.sliding_window(S, S, 3 * bk, bq=bq, bk=bk)
        return {"causal": M.causal(S, S, bq=bq, bk=bk),
                "window": M.sliding_window(S, S, 2 * bk, bq=bq, bk=bk),
                "local|global": local | M.global_cols(S, S, 1, bq=bq,
                                                      bk=bk)}[pattern]

    m = masks(BlockMask)

    def ref():
        r = _ref()
        return r.engine.shard_attention_sparse(
            *(r.jnp.asarray(x) for x in (q, k, v)), masks(r.masks.BlockMask),
            interpret=True)

    return Case(world=4, op="shard_attention_sparse",
                args=(_t(q), _t(k), _t(v), m), kwargs={}, mesh=None,
                single=lambda: fops.attention(_t(q), _t(k), _t(v), mask=m,
                                              mask_impl="sparse",
                                              fallback="error"),
                ref=ref, exact=False)


def _flash_case(key, mesh, window):
    rng = _rng(key)
    q = rng.standard_normal((2, 4, 256, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 256, 16)).astype(np.float32)
            for _ in range(2))

    def ref():
        r = _ref()
        return r.fk.flash_attention(*(r.jnp.asarray(x) for x in (q, k, v)),
                                    causal=True, window=window,
                                    interpret=True)

    return Case(world=4, op="sharded_flash_attention",
                args=(_t(q), _t(k), _t(v)),
                kwargs=dict(causal=True, window=window),
                mesh=FLASH_MESHES[mesh],
                single=lambda: layers.sharded_flash_attention(
                    _t(q), _t(k), _t(v), causal=True, window=window),
                ref=ref, exact=False)


def _specs():
    """Every case by key, built where it is first needed (the parent)."""
    s = {}
    for n_dev in (2, 4):
        for N in (512, 256):
            s[f"spmm_bitwise-{N}-{n_dev}"] = functools.partial(
                _spmm_case, n_dev=n_dev, shape=(64, 64), density=0.3, N=N,
                ref_bn=128, sharded_ref=(N, n_dev) != (256, 4))
        s[f"spmspm_bitwise-{n_dev}"] = functools.partial(
            _spmspm_case, n_dev=n_dev, a_shape=(24, 96), a_density=0.3,
            b_shape=(96, 32), b_density=0.1, rt=8, ct=8, sharded_ref=True)
    for N in (100, 300, 129):
        s[f"spmm_uneven-{N}"] = functools.partial(
            _spmm_case, n_dev=4, shape=(32, 64), density=0.4, N=N)
    s["spmm_powerlaw"] = functools.partial(
        _spmm_case, n_dev=2, shape=(64, 64), density=0.1, N=200,
        gen=powerlaw_sparse)
    s["spmm_auto_mesh"] = functools.partial(
        _spmm_case, n_dev=4, shape=(32, 32), density=0.5, N=256, auto=True)
    for B in (4, 3, 6):
        s[f"batched_per_matrix-{B}"] = functools.partial(
            _batched_case, n_dev=4, B=B, shape=(64, 64), density=0.2, N=160)
    s["batched_broadcast"] = functools.partial(
        _batched_case, n_dev=2, B=4, shape=(32, 32), density=0.3, N=128,
        broadcast=True, sharded_ref=True)
    s["batched_bucketed"] = functools.partial(
        _batched_case, n_dev=4, B=4, shape=(64, 64), density=0.1, N=160,
        op="shard_spmm_batched_bucketed", sharded_ref=True)
    s["batched_stream"] = functools.partial(
        _batched_case, n_dev=2, B=2, shape=(32, 32), density=0.3, N=128,
        op="shard_spmm_batched_stream", sharded_ref=True)
    s["batched_dispatch_copy"] = functools.partial(
        _batched_case, n_dev=4, B=4, shape=(64, 64), density=0.0, N=128,
        op="shard_spmm_batched_stream", dispatch=True)
    s["spmspm_uneven"] = functools.partial(
        _spmspm_case, n_dev=4, a_shape=(16, 64), a_density=0.4,
        b_shape=(64, 22), b_density=0.15, oracle=True)
    s["spmspm_empty"] = functools.partial(
        _spmspm_case, n_dev=2, a_shape=(16, 64), a_density=0.4,
        b_shape=(64, 16), b_density=0.0, empty=True, sharded_ref=True)
    for N in (512, 320):
        s[f"spmm_nt-{N}"] = functools.partial(
            _spmm_case, n_dev=2, shape=(64, 64), density=0.2, N=N, bn=128,
            nt=2, ref_bn=128, ref_nt=1, sharded_ref=N == 512)
    s["batched_stream_nt"] = functools.partial(
        _batched_case, n_dev=2, B=2, shape=(32, 32), density=0.3, N=256,
        op="shard_spmm_batched_stream", bn=128, nt=2, sharded_ref=True)
    s["batched_bucketed_nt"] = functools.partial(
        _batched_case, n_dev=2, B=2, shape=(32, 32), density=0.3, N=256,
        op="shard_spmm_batched_bucketed", bn=128, nt=2, sharded_ref=True)
    s["spmspm_nt"] = functools.partial(
        _spmspm_case, n_dev=2, a_shape=(32, 128), a_density=0.1,
        b_shape=(128, 40), b_density=0.05, rt=8, ct=8, nt=2)
    for name in QUANT:
        s[f"spmm_quant-{name}"] = functools.partial(
            _spmm_case, n_dev=4, shape=(64, 64), density=0.15, N=256,
            gen=_block_sparse, quant=name)
    s["batched_quant"] = functools.partial(
        _batched_case, n_dev=4, B=4, shape=(64, 64), density=0.15, N=128,
        gen=_block_sparse, quant="int8", sharded_ref=True)
    s["spmspm_quant"] = functools.partial(
        _spmspm_case, n_dev=4, a_shape=(32, 64), a_density=0.2,
        b_shape=(64, 64), b_density=0.2, quant="fp8_e4m3")
    for p in ATTN_PATTERNS:
        s[f"attention-{p}"] = functools.partial(_attention_case, pattern=p)
    for mesh in FLASH_MESHES:
        for window in (None, 96):
            s[f"flash-{mesh}-{window}"] = functools.partial(
                _flash_case, mesh=mesh, window=window)
    return s


SPECS = _specs()


# ----------------------------------------------------------------- ranks ----

def _rank_cases(rank, world, calls):
    """The ranks' side: every call of this world once, and the checks that
    need a group.  Returns {key: result}."""
    from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                         mesh_context)
    meshes = {}
    out = {}
    for key, (op, args, kwargs, sizes) in calls.items():
        mesh = None
        if sizes is not None:
            skey = tuple(sorted(sizes.items()))
            if skey not in meshes:
                meshes[skey] = make_host_mesh(**sizes, device_type="cpu",
                                              timeout=GROUP_TIMEOUT)
            mesh = meshes[skey]
        if op == "sharded_flash_attention":
            with mesh_context(mesh):
                out[key] = layers.sharded_flash_attention(*args, **kwargs)
                q, k, v = (t.clone().requires_grad_() for t in args)
                y = layers.FlashFwdChunkedBwd.apply(q, k, v,
                                                    kwargs["window"])
                y.backward(torch.ones_like(y))
                out[key + "/grad"] = (y.detach(), q.grad, k.grad, v.grad)
        else:
            out[key] = getattr(engine, op)(*args, mesh=mesh, **kwargs)
    if world == 4:
        try:
            make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            out["production"] = str(e)
        q = torch.zeros((2, 4, 96, 16))
        try:
            with mesh_context(meshes[(("data", 2), ("model", 2))]):
                layers.sharded_flash_attention(q, q[:, :2], q[:, :2])
        except ValueError as e:
            out["uneven"] = str(e)
        out["auto_mesh"] = engine.auto_mesh(device_type="cpu")[0] \
            .mesh_dim_names
    return out


@pytest.fixture(scope="module")
def sharded():
    """{key: (case, result)}: each world's calls run once in one spawn; the
    results of all ranks must be equal."""
    cases = {key: build(key) for key, build in SPECS.items()}
    results = {}
    for world in (4, 2):
        calls = {key: (c.op, c.args, c.kwargs, c.mesh)
                 for key, c in cases.items() if c.world == world}
        per_rank = run_ranks(_rank_cases, world, calls,
                             timeout=GROUP_TIMEOUT, limit=LIMIT)
        for key, got in per_rank[0].items():
            for other in per_rank[1:]:
                _equal(other[key], got, key)
            results[key] = got
    return cases, results


def _equal(a, b, what):
    if isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _equal(x, y, what)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def _check(sharded, key):
    cases, results = sharded
    case, got = cases[key], results[key]
    _equal(got, case.single(), f"{key}: sharded != one device")
    want = np.asarray(case.ref())
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if case.exact:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    oracle = getattr(case, "oracle", None)
    if oracle is not None:
        A, Bm = oracle
        np.testing.assert_allclose(got.numpy(), A @ Bm, **TOL)


# ----------------------------------------------------------------- tests ----

@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("N", [512, 256])
def test_shard_spmm_bitwise_matches_single_device(sharded, n_dev, N):
    _check(sharded, f"spmm_bitwise-{N}-{n_dev}")


@pytest.mark.parametrize("N", [100, 300, 129])
def test_shard_spmm_uneven_n_tiles(sharded, N):
    _check(sharded, f"spmm_uneven-{N}")


def test_shard_spmm_matches_oracle_powerlaw(sharded):
    _check(sharded, "spmm_powerlaw")
    case, got = sharded[0]["spmm_powerlaw"], sharded[1]["spmm_powerlaw"]
    a, b = case.args
    torch.testing.assert_close(got, a.todense() @ b, **TOL)


def test_shard_spmm_auto_mesh(sharded):
    """mesh=None resolves to a 1-D ("data",) mesh over the whole group."""
    _check(sharded, "spmm_auto_mesh")
    assert sharded[1]["auto_mesh"] == ("data",)


@pytest.mark.parametrize("B", [4, 3, 6])
def test_shard_spmm_batched_matches_per_matrix(sharded, B):
    _check(sharded, f"batched_per_matrix-{B}")
    case, got = sharded[0][f"batched_per_matrix-{B}"], \
        sharded[1][f"batched_per_matrix-{B}"]
    a, d = case.args
    for i in range(B):
        assert torch.equal(got[i], spmm_ops.spmm(a[i], d[i]))


def test_shard_spmm_batched_broadcast_dense(sharded):
    _check(sharded, "batched_broadcast")


def test_shard_spmm_batched_bucketed_matches_unbucketed(sharded):
    _check(sharded, "batched_bucketed")


def test_shard_spmm_batched_stream_matches_batched(sharded):
    """The stream entry (no host read of the stream) == the host-side
    batched entry."""
    _check(sharded, "batched_stream")


def test_shard_dispatch_copy_is_bitwise(sharded):
    """A 0/1 dispatch stream copies rows: bit for bit the reference's."""
    _check(sharded, "batched_dispatch_copy")


@pytest.mark.parametrize("n_dev", [2, 4])
def test_shard_spmspm_bitwise_matches_single_device(sharded, n_dev):
    _check(sharded, f"spmspm_bitwise-{n_dev}")


def test_shard_spmspm_uneven_columns(sharded):
    _check(sharded, "spmspm_uneven")


def test_shard_spmspm_empty_operand(sharded):
    _check(sharded, "spmspm_empty")
    assert not sharded[1]["spmspm_empty"].any()


@pytest.mark.parametrize("N", [512, 320])
def test_shard_spmm_nt_matches_single_device(sharded, N):
    _check(sharded, f"spmm_nt-{N}")


@pytest.mark.parametrize("key", ["batched_stream_nt", "batched_bucketed_nt"])
def test_shard_spmm_batched_stream_nt(sharded, key):
    """The reference's sharded call at nt 2 == the port's, which has no
    ``nt``."""
    _check(sharded, key)


def test_shard_spmspm_nt_matches_single_device(sharded):
    _check(sharded, "spmspm_nt")


@pytest.mark.parametrize("name", QUANT)
def test_shard_spmm_quant_bit_identical(sharded, name):
    """K2q split over 4 ranks == one device, and == the reference's
    kernel on host-dequantized blocks within 1e-5."""
    _check(sharded, f"spmm_quant-{name}")


def test_shard_spmm_batched_quant_bit_identical(sharded):
    _check(sharded, "batched_quant")


def test_shard_spmspm_quant_bit_identical(sharded):
    _check(sharded, "spmspm_quant")


@pytest.mark.parametrize("name", ATTN_PATTERNS)
def test_sharded_attention_matches_single_device(sharded, name):
    """K4s with the query axis over 4 ranks, each sub-mask at its
    absolute q_offset and the common bucket: == the one-device walk."""
    _check(sharded, f"attention-{name}")


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("mesh", sorted(FLASH_MESHES))
def test_sharded_flash_attention_matches_k3(sharded, mesh, window):
    """K3 with q split by batch over the data axes and by sequence over
    "model" == the one-device K3, and the reference's K3 (interpret mode)
    on the whole sequence within 1e-5; under the mesh
    ``FlashFwdChunkedBwd``'s forward and its chunked gradients == one
    device."""
    key = f"flash-{mesh}-{window}"
    _check(sharded, key)
    case, (y, *grads) = sharded[0][key], sharded[1][key + "/grad"]
    q, k, v = (t.clone().requires_grad_() for t in case.args)
    want = layers.FlashFwdChunkedBwd.apply(q, k, v, window)
    want.backward(torch.ones_like(want))
    assert torch.equal(y, want.detach())
    for g, w in zip(grads, (q.grad, k.grad, v.grad)):
        assert torch.equal(g, w)


def test_refusals_on_ranks(sharded):
    results = sharded[1]
    assert "needs 256 ranks; the world has 4" in results["production"]
    assert "multiple of K3's q tile" in results["uneven"]


def test_no_group_calls_the_one_device_wrappers():
    """Without a process group the entry points resolve no mesh and give
    the one-device wrapper's result on the whole operand."""
    assert not torch.distributed.is_initialized()
    assert engine.auto_mesh() == (None, "data")
    for key in ("spmm_uneven-300", "batched_per_matrix-3", "spmspm_uneven",
                "attention-window"):
        case = SPECS[key](key)
        got = getattr(engine, case.op)(*case.args, **case.kwargs)
        assert torch.equal(got, case.single()), key
    case = SPECS["flash-data_model-None"]("flash-data_model-None")
    assert torch.equal(layers.sharded_flash_attention(*case.args, causal=True),
                       fops.attention(*case.args, fallback="error"))


@pytest.mark.parametrize("n_dev", [3, 4])
@pytest.mark.parametrize("key", ["spmm_uneven-300", "batched_per_matrix-6",
                                 "spmspm_uneven", "spmm_quant-int8"])
def test_rank_parts_concatenate_to_one_device(key, n_dev):
    """Each rank's share (the ``*_part`` plans, what a rank launches and
    ``chip_smoke.py`` times), run here for every coordinate without a
    group, concatenated and cut, == the one-device call: any rank count,
    3 included."""
    case = SPECS[key](key)
    plan = {"shard_spmm": engine.spmm_part,
            "shard_spmm_batched": engine.spmm_batched_part,
            "shard_spmspm": engine.spmspm_part}[case.op]
    args = case.args
    if case.op == "shard_spmm_batched":
        args = (spmm_ops.pad_empty_rows(args[0]),) + args[1:]
    parts = [plan(*args, n_dev, i, **case.kwargs) for i in range(n_dev)]
    whole = torch.cat([p.run() for p in parts], parts[0].dim)
    assert torch.equal(whole[parts[0].keep], case.single()), key


def test_attention_and_flash_parts_concatenate_to_one_device():
    case = SPECS["attention-causal"]("attention-causal")
    q, k, v, m = case.args
    parts = [engine.attention_sparse_part(q, k, v, m, 4, i)
             for i in range(4)]
    assert torch.equal(torch.cat([p.run() for p in parts], 2),
                       case.single())
    case = SPECS["flash-data_model-96"]("flash-data_model-96")
    q, k, v = case.args
    rows = []
    for d in range(2):
        rows.append(torch.cat([layers.flash_part(
            q, k, v, _FakeMesh(data=(2, d), model=(2, m)), causal=True,
            window=96)() for m in range(2)], 2))
    assert torch.equal(torch.cat(rows, 0), case.single())


class _FakeMesh:
    """A mesh's names, sizes and this rank's coordinates, no group."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(n for n, _ in axes.values())
        self._coord = {a: i for a, (_, i) in axes.items()}

    def get_local_rank(self, axis):
        return self._coord[axis]


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    a = bcsr_from_dense(np.eye(16, dtype=np.float32), (8, 8), device="cpu")
    return engine.shard_spmm(a, torch.ones((16, 256)))


def _hung_rank(rank, world):
    if rank == 1:
        time.sleep(600)
    a = bcsr_from_dense(np.eye(16, dtype=np.float32), (8, 8), device="cpu")
    return engine.shard_spmm(a, torch.ones((16, 256)))


def test_a_failing_rank_fails_within_the_group_timeout():
    timeout = 20.0
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        run_ranks(_failing_rank, 4, timeout=timeout, limit=3 * timeout)
    assert time.monotonic() - t0 < timeout


def _sleeping_rank(rank, world):
    time.sleep(600)


def test_a_hung_rank_is_stopped():
    """Rank 0 fails at the group timeout, blocked by the sleeper, which is
    then killed; ranks that all sleep are killed at the limit."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match=r"(?s)rank 0:.*ranks \[1\] gave no "
                       r"result \(stopped after a failure\)"):
        run_ranks(_hung_rank, 2, timeout=3.0, limit=60.0)
    assert time.monotonic() - t0 < 15.0
    t0 = time.monotonic()
    with pytest.raises(RankError, match=r"ranks \[0, 1\] gave no result "
                       r"\(stopped at 4.0 s\)"):
        run_ranks(_sleeping_rank, 2, timeout=3.0, limit=4.0)
    assert time.monotonic() - t0 < 10.0
