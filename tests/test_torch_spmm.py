"""Port vs reference: the BCSR SpMM (K2) ops, containers and stream engine.

Inputs come from a numpy seed and go through both the reference (Pallas in
interpret mode) and the port's plain PyTorch path (CPU tensors).  f32
products may sum a block's terms in another order than the Pallas dot, so
f32 compares with atol = rtol = 1e-5; 0/1 blocks copy exactly and must be
equal.  The CUDA kernel itself runs only on the GPU, where ``chip_smoke.py``
holds it against the same plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import formats as rf
from repro.kernels import engine as r_engine
from repro.kernels import tuning as r_tuning
from repro.kernels.spmm import ops as r_ops

from repro_torch.core.formats import BatchedBCSR
from repro_torch.interop import bcsr_from_jax, to_tensor
from repro_torch.kernels import engine, tuning
from repro_torch.kernels.spmm import kernel, ops

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _port(a):
    """A reference BCSR / BatchedBCSR as the port's container, on the CPU."""
    return bcsr_from_jax(a, device="cpu")


@pytest.mark.parametrize("density,block,mkn", [
    (0.05, (8, 8), (64, 64, 128)),
    (0.3, (8, 16), (128, 96, 256)),
    (1.0, (8, 8), (64, 64, 200)),
    (0.3, (16, 8), (64, 32, 128)),
])
def test_spmm_matches_reference(density, block, mkn):
    rng = np.random.default_rng(7)
    m, k, n = mkn
    a = rf.bcsr_from_dense(rf.random_dense_sparse(rng, (m, k), density), block)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(r_ops.spmm(a, jnp.asarray(b), bn=128, interpret=True))
    got = ops.spmm(_port(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_empty_rows():
    rng = np.random.default_rng(3)
    a_dense = np.zeros((64, 64), np.float32)
    a_dense[9, :16] = 1.0           # one block-row non-empty
    a = rf.bcsr_from_dense(a_dense, (8, 8))
    b = rng.standard_normal((64, 128)).astype(np.float32)
    want = np.asarray(r_ops.spmm(a, jnp.asarray(b), interpret=True))
    got = ops.spmm(_port(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("broadcast", [False, True])
def test_spmm_batched_matches_reference(broadcast):
    rng = np.random.default_rng(11)
    B, m, k, n = 3, 64, 48, 136
    dense = np.stack([rf.random_dense_sparse(rng, (m, k), 0.2)
                      for _ in range(B)])
    a = rf.batched_bcsr_from_dense(dense, (8, 8))
    b = rng.standard_normal((k, n) if broadcast else (B, k, n)
                            ).astype(np.float32)
    want = np.asarray(r_ops.spmm_batched(a, jnp.asarray(b), interpret=True))
    got = ops.spmm_batched(_port(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_spmm_zero_one_blocks_exact():
    """A 0/1 (dispatch-like) matrix copies rows: equal, not close."""
    rng = np.random.default_rng(5)
    B, m, k, n = 2, 40, 32, 96
    dense = np.zeros((B, m, k), np.float32)
    for bb in range(B):
        cols = rng.permutation(k)[:m // 2]
        dense[bb, np.arange(m // 2) * 2, cols] = 1.0
    a = rf.batched_bcsr_from_dense(dense, (8, 8))
    b = rng.standard_normal((B, k, n)).astype(np.float32)
    want = np.asarray(r_ops.spmm_batched(a, jnp.asarray(b), interpret=True))
    got = ops.spmm_batched(_port(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spmm_bf16_output_rounds_per_entry():
    """bf16 blocks, dense and output: each entry's block product is rounded
    to bf16 before it is added, as the Pallas body does; the port agrees
    with the reference within one bf16 ulp of the largest value."""
    rng = np.random.default_rng(9)
    a = rf.bcsr_from_dense(rf.random_dense_sparse(rng, (64, 64), 0.4), (8, 8))
    a16 = rf.BCSR(indptr=a.indptr, block_rows=a.block_rows,
                  block_cols=a.block_cols, blocks=a.blocks.astype(jnp.bfloat16),
                  shape=a.shape, block=a.block)
    b = jnp.asarray(rng.standard_normal((64, 128)), jnp.bfloat16)
    want = np.asarray(r_ops.spmm(a16, b, out_dtype=jnp.bfloat16,
                                 interpret=True)).astype(np.float32)
    got = ops.spmm(_port(a16), to_tensor(np.asarray(b)),
                   out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ulp, rtol=0)


def test_containers_match_reference():
    """with_capacity, pad_empty_rows and todense reproduce the reference's
    index streams and dense values."""
    rng = np.random.default_rng(2)
    dense = np.stack([rf.random_dense_sparse(rng, (48, 32), 0.15)
                      for _ in range(2)])
    dense[:, 8:16] = 0.0            # an empty block-row
    a = rf.batched_bcsr_from_dense(dense, (8, 8))
    pa = _port(a)
    np.testing.assert_array_equal(pa.todense().numpy(), np.asarray(a.todense()))
    for r_s, p_s in ((r_ops.pad_empty_rows(a), ops.pad_empty_rows(pa)),
                     (a.with_capacity(32), pa.with_capacity(32))):
        for f in ("indptr", "block_rows", "block_cols", "blocks"):
            np.testing.assert_array_equal(getattr(p_s, f).numpy(),
                                          np.asarray(getattr(r_s, f)))
        np.testing.assert_array_equal(p_s.todense().numpy(), dense)
    with pytest.raises(ValueError):
        pa.with_capacity(pa.nnzb - 1)


def test_engine_buckets_and_stream_entry():
    for n in (0, 1, 7, 8, 9, 100, 1024, 1025):
        assert engine.stream_bucket(n) == r_engine.stream_bucket(n)
        assert engine.stream_bucket(n, minimum=32) == \
            r_engine.stream_bucket(n, minimum=32)
        assert engine.batch_bucket(n, cap=16) == \
            r_engine.batch_bucket(n, cap=16)
    rng = np.random.default_rng(4)
    a = rf.batched_bcsr_from_dense(
        np.stack([rf.random_dense_sparse(rng, (32, 32), 0.5)] * 4), (8, 8))
    pa = ops.pad_empty_rows(_port(a)).with_capacity(32)
    b = rng.standard_normal((32, 64)).astype(np.float32)
    got = engine.spmm_batched_stream(pa, torch.from_numpy(b))
    want = np.asarray(r_engine.shard_spmm_batched_stream(
        r_ops.pad_empty_rows(a).with_capacity(32), jnp.asarray(b),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pipe = engine.StreamPipeline(0)
    pipe.push("plan", got)
    assert len(pipe) == 0 and pipe.pushes == 1
    with pytest.raises(NotImplementedError):
        engine.StreamPipeline(1)


def test_wrapper_plain_path_and_guards():
    """CPU tensors take the plain version and launch nothing, wide or with
    scales (K2q), and the scales are applied, not ignored; narrow blocks
    without scales are refused by the container."""
    rng = np.random.default_rng(6)
    a = _port(rf.batched_bcsr_from_dense(
        np.stack([rf.random_dense_sparse(rng, (16, 16), 0.5)]), (8, 8)))
    b = torch.from_numpy(rng.standard_normal((1, 16, 40)).astype(np.float32))
    before = (kernel.spmm_bcsr.launches, kernel.spmm_bcsr.quant_launches)
    out = kernel.spmm_bcsr(a.indptr, a.block_cols, a.blocks, b)
    torch.testing.assert_close(out, torch.matmul(a.todense(), b), **TOL)
    aq = a.quantize("int8")
    outq = kernel.spmm_bcsr(a.indptr, a.block_cols, aq.blocks, b,
                            scales=aq.scales)
    torch.testing.assert_close(outq, torch.matmul(aq.todense(), b), **TOL)
    assert (kernel.spmm_bcsr.launches,
            kernel.spmm_bcsr.quant_launches) == before
    with pytest.raises(ValueError, match="scales"):
        BatchedBCSR(indptr=a.indptr, block_rows=a.block_rows,
                    block_cols=a.block_cols, blocks=aq.blocks,
                    shape=a.shape, block=a.block)


@pytest.mark.parametrize("entry", ["spmm", "spmm_batched", "stream"])
def test_out_dtype_defaults_to_f32_as_the_reference(entry):
    """A bf16 dense operand gives an f32 result by default, as in the
    reference (``out_dtype=jnp.float32``).  Both sides widen bf16 exactly
    and sum f32 block products, so the values agree within 1e-5.  B = 4:
    the reference's stream engine shards the batch over 4 virtual
    devices."""
    rng = np.random.default_rng(12)
    a = rf.batched_bcsr_from_dense(
        np.stack([rf.random_dense_sparse(rng, (32, 48), 0.3)] * 4), (8, 8))
    b = jnp.asarray(rng.standard_normal((4, 48, 72)), jnp.bfloat16)
    pb = to_tensor(np.asarray(b))
    if entry == "spmm":
        want = r_ops.spmm(a[0], b[0], interpret=True)
        got = ops.spmm(_port(a[0]), pb[0])
    elif entry == "spmm_batched":
        want = r_ops.spmm_batched(a, b, interpret=True)
        got = ops.spmm_batched(_port(a), pb)
    else:
        pa = r_ops.pad_empty_rows(a)
        want = r_engine.shard_spmm_batched_stream(pa, b, interpret=True)
        got = engine.spmm_batched_stream(_port(pa), pb)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cpu_tuning_rows_match_reference():
    """The routed stream's geometry on the CPU equals the reference's."""
    for dt, rdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = r_tuning.moe_dispatch_tiles(64, rdt)
        got = tuning.moe_dispatch_tiles(64, dt, "cpu")
        assert got["block"] == want["block"]
        assert got["min_bucket"] == want["min_bucket"]
