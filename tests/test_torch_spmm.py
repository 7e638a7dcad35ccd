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
    with pytest.raises(ValueError):
        engine.StreamPipeline(2)


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
    # The K2q tile guard (the wrapper's for narrow blocks on the card): bn
    # 128 x a power of two, at most eight warps of 8 rows x 128 columns, a
    # (bk, bn) dense tile in 32 KB; any dense dtype, so bn 128 on bf16 too
    f32, bf16 = torch.float32, torch.bfloat16
    for bm, bk, bn, dt, group in ((8, 8, 128, f32, 8), (8, 8, 128, bf16, 8),
                                  (8, 8, 256, f32, 4), (8, 8, 1024, f32, 1),
                                  (16, 8, 128, f32, 4), (16, 8, 512, bf16, 1),
                                  (8, 32, 256, f32, 4), (8, 1, 128, f32, 8)):
        assert tuning.spmm_quant_group(bm, bk, bn, dt) == group
    for bm, bk, bn, dt in ((8, 8, 64, f32), (8, 8, 384, f32),
                           (8, 8, 2048, f32), (16, 8, 1024, f32),
                           (8, 32, 512, f32), (8, 32, 1024, bf16),
                           (12, 8, 128, f32), (8, 33, 128, f32)):
        with pytest.raises(ValueError, match="K2q tile"):
            tuning.spmm_quant_group(bm, bk, bn, dt)


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


# ---------------------------------------------------------------------------
# The laws the Hopper kernel's skips rely on, and the dispatch streams that
# ``tools/compare_spmm.py`` times.
# ---------------------------------------------------------------------------

def _compare_spmm():
    """``tools/compare_spmm.py`` as a module (its stream maker)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "compare_spmm.py"
    spec = importlib.util.spec_from_file_location("compare_spmm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scout():
    from repro_torch.configs import get_config
    return get_config("llama4-scout-17b-a16e")


def _routed(rng, B, S, zipf, dtype):
    """A bucket-padded routed dispatch stream at llama4-scout's dispatch
    geometry (E 16, capacity factor 1.25, CPU tiles), its slots and C."""
    from repro_torch.models import moe
    cfg, cs = _scout(), _compare_spmm()
    C = moe.dispatch_capacity(S, cfg)
    expert = cs.expert_choice(rng, B, S, cfg.n_experts, zipf)
    fs = cs.routed_slots(expert, cfg)
    a, C2 = cs.dispatch_stream(fs, cfg, dtype, "cpu")
    assert C2 == C
    return a, fs, C, expert


def _drop_zero_blocks(a: BatchedBCSR) -> BatchedBCSR:
    """The stream without its entries whose block is zero in every batch,
    the others kept in stream order, ``indptr`` recomputed."""
    keep = (a.blocks != 0).flatten(2).any(-1).any(0)
    rows = a.block_rows[keep]
    gm = a.grid_shape[0]
    indptr = torch.zeros(gm + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(torch.bincount(rows.long(), minlength=gm), 0)
    return BatchedBCSR(indptr=indptr, block_rows=rows,
                       block_cols=a.block_cols[keep],
                       blocks=a.blocks[:, keep].contiguous(), shape=a.shape,
                       block=a.block)


@pytest.mark.parametrize("stream", ["random", "routed"])
@pytest.mark.parametrize("dense_kind", ["random", "neg_zero"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_zero_blocks_add_nothing(stream, dense_kind, out_dtype):
    """The kernel skips zero blocks; the plain version, which walks every
    entry, gives equal results without them: on random and on bucket-padded
    routed streams, with random dense values and with dense holding -0.0
    (a zero block against -0.0 gives a -0.0 product), f32 and bf16 out."""
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    rng = np.random.default_rng(21)
    dt = out_dtype
    if stream == "random":
        B, gm, gn, bm, bk = 3, 6, 5, 8, 8
        blocks = rng.standard_normal((B, gm * gn, bm, bk)).astype(np.float32)
        blocks[:, rng.random(gm * gn) < 0.4] = 0.0    # zero in every batch
        blocks[1, rng.random(gm * gn) < 0.3] = 0.0    # zero in one batch
        coords = np.arange(gm * gn)
        a = BatchedBCSR(
            indptr=torch.arange(0, gm * gn + 1, gn, dtype=torch.int32),
            block_rows=torch.from_numpy((coords // gn).astype(np.int32)),
            block_cols=torch.from_numpy((coords % gn).astype(np.int32)),
            blocks=torch.from_numpy(blocks).to(dt), shape=(B, gm * bm,
                                                           gn * bk),
            block=(bm, bk)).with_capacity(gm * gn + 13)
    else:
        a = _routed(rng, 4, 40, False, dt)[0]
    B, K = a.batch, a.shape[2]
    dense = rng.standard_normal((B, K, 24)).astype(np.float32)
    if dense_kind == "neg_zero":
        dense[:, ::3] = -0.0
        dense[:, :, ::2] = -np.abs(dense[:, :, ::2])
    dense = torch.from_numpy(dense).to(dt)
    stripped = _drop_zero_blocks(a)
    assert stripped.nnzb < a.nnzb
    want = spmm_bcsr_ref(a.indptr, a.block_cols, a.blocks, dense,
                         out_dtype=dt)
    got = spmm_bcsr_ref(stripped.indptr, stripped.block_cols,
                        stripped.blocks, dense, out_dtype=dt)
    assert torch.equal(got, want)


@pytest.mark.parametrize("S,zipf", [(40, False), (40, True), (256, False),
                                    (256, True)])
def test_routed_stream_pads_the_last_row(S, zipf):
    """Every bucket pad entry lies in the last block-row (a zero block at
    the last coordinate), so the last row is the stream's longest walk;
    ``ops.stream_row_stats`` counts it as the kernel walks it."""
    rng = np.random.default_rng(S + zipf)
    a = _routed(rng, 4, S, zipf, torch.float32)[0]
    gm = a.grid_shape[0]
    nz = (a.blocks != 0).flatten(2).any(-1).any(0)
    coords = a.block_rows.long() * a.grid_shape[1] + a.block_cols.long()
    covered = int(coords.unique().numel())
    assert covered < a.nnzb == engine.stream_bucket(covered, minimum=8)
    assert (a.block_rows[covered:] == gm - 1).all()
    assert (coords[covered:] == coords[covered - 1]).all()
    assert not nz[covered:].any()
    counts = a.indptr.long().diff()
    assert int(counts[-1]) == int(counts.max()) \
        >= a.nnzb - covered + 1
    st = ops.stream_row_stats(a)
    assert st == {
        "gm": gm, "nnzb_stream": a.nnzb, "nnzb_covered": covered,
        "nnzb_routed": int(nz.sum()), "row_max": int(counts.max()),
        "row_last": int(counts[-1]),
        "row_median_others": float(counts[:-1].median()),
        "zero_blocks": int((~(a.blocks != 0).flatten(2).any(-1)).sum())}


@pytest.mark.parametrize("S,zipf", [(40, False), (40, True), (200, False),
                                    (200, True)])
def test_compare_spmm_streams_dispatch_like_gather(S, zipf):
    """``compare_spmm.py``'s streams (the port's routing of seeded expert
    choices at llama4-scout's geometry) through the plain version give the
    gather dispatch's buffer, bit for bit (bcsr == gather), in bf16 at a
    small width; each kept token sits in its chosen expert's queue, at a
    position no other token of its row takes: its queue position, which
    counts the earlier tokens of its (row, expert), kept or dropped."""
    from repro_torch.models import moe
    rng = np.random.default_rng(3 * S + zipf)
    a, fs, C, expert = _routed(rng, 4, S, zipf, torch.bfloat16)
    E = _scout().n_experts
    kept = fs < E * C
    assert kept.any() and (fs[kept] // C == expert[kept]).all()
    for b in range(fs.shape[0]):
        assert len(np.unique(fs[b][kept[b]])) == int(kept[b].sum())
        for e in range(E):
            mine = expert[b] == e
            queue = np.arange(int(mine.sum()))[kept[b][mine]]
            assert (fs[b][mine & kept[b]] % C == queue).all()
    xt = torch.from_numpy(rng.standard_normal((4, S, 40)).astype(
        np.float32)).to(torch.bfloat16)
    got = moe._dispatch_stream(xt, a, E, C)
    want = moe._dispatch_gather(xt, torch.from_numpy(fs), E, C)
    assert torch.equal(got, want)


def test_cuda_tile_rows():
    """The card's SpMM tiles: ``bn`` is a multiple of the kernel's column
    unit (a warp of 16-byte vectors) and at most 8 units, for the dispatch
    at every width and for the library rows."""
    assert tuning.spmm_col_unit(torch.float32) == 128
    assert tuning.spmm_col_unit(torch.bfloat16) == 256
    for dt in (torch.float32, torch.bfloat16):
        unit = tuning.spmm_col_unit(dt)
        for d in (16, 64, 300, 4096, 5120):
            bn = tuning.moe_dispatch_tiles(d, dt, "cuda")["bn"]
            assert bn % unit == 0 and unit <= bn <= 8 * unit
            assert bn <= max(unit, -(-d // unit) * unit)
        assert tuning.spmm_bn(dt, "cuda") % unit == 0
    assert tuning.moe_dispatch_tiles(5120, torch.bfloat16, "cuda")["bn"] \
        == 1024
    # K2q: the fp8 row's bn and group, which the kernel's eight warps give
    # (8 block-rows of 8 x 8 blocks at bn 128, 4 of 16 x 8), on either dense
    row = tuning._row("spmm", torch.float8_e4m3fn, "cuda")
    bn = tuning.spmm_bn(torch.float8_e4m3fn, "cuda")
    assert row == {"bn": 128, "group": 8} and bn == 128
    for dt in (torch.float32, torch.bfloat16):
        assert tuning.spmm_quant_group(8, 8, bn, dt) == row["group"]
        assert tuning.spmm_quant_group(16, 8, bn, dt) == row["group"] // 2
        assert tuning.spmm_quant_group(8, 32, bn, dt) == row["group"]
    assert tuning._row("spmm", torch.float8_e4m3fn, "cpu") == {"bn": 128}


# ---------------------------------------------------------------------------
# K2q's traversal (``spmm_quant_kernel`` in ``csrc/spmm_bcsr.cu``), emulated.
# ---------------------------------------------------------------------------

_NO_COL = 2**31 - 1


def _entry_products(indptr, cols, blocks, dense):
    """Each stream entry's block product (B, nnzb, bm, N), taken by the same
    calls, on the same entries, as ``spmm_bcsr_ref`` takes them (one depth
    of the rows at a time), so that the products are its bits."""
    B, nnzb, bm, bk = blocks.shape
    indptr = indptr.long()
    counts = indptr.diff()
    rows = torch.repeat_interleave(torch.arange(counts.numel()), counts)
    depth = torch.arange(nnzb) - indptr[rows]
    tiles = dense.reshape(B, -1, bk, dense.shape[-1])
    part = torch.empty((B, nnzb, bm, dense.shape[-1]))
    for j in range(int(counts.max()) if nnzb else 0):
        sel = torch.nonzero(depth == j).squeeze(1)
        part[:, sel] = torch.matmul(blocks[:, sel].float(),
                                    tiles[:, cols.long()[sel]].float())
    return part


def _emulate_k2q(indptr, cols, blocks, scales, dense, group, window):
    """``spmm_quant_kernel`` step for step in plain torch, for one thread
    block per group of ``group`` block-rows: a window starts at the least
    head column of the rows going on in their sweep (of all rows when none
    can: a new sweep); each row marks its entries from the cursor while
    they stay in the window and do not descend; the marked K-tiles, in
    ascending order, are the steps, each staged once; at a step each row
    whose head entry has the step's column takes it (again while the next
    one does) and adds its product.  Returns the output, each row's visited
    entries in the order taken, and the K-tiles staged."""
    from repro_torch.core.precision import dequantize_blocks
    part = _entry_products(indptr, cols, dequantize_blocks(blocks, scales),
                           dense)
    ip, cl = indptr.tolist(), cols.tolist()
    gm = len(ip) - 1
    B, _, bm, _ = blocks.shape
    acc = torch.zeros((B, gm, bm, dense.shape[-1]))
    visits = [[] for _ in range(gm)]
    staged = 0
    for g0 in range(0, gm, group):
        rows = range(g0, min(g0 + group, gm))
        cur = {r: ip[r] for r in rows}
        floor = {r: -1 for r in rows}

        def head(r):
            return cl[cur[r]] if cur[r] < ip[r + 1] else _NO_COL
        while True:
            least = min(head(r) for r in rows)
            if least == _NO_COL:
                break
            going = [head(r) for r in rows if head(r) >= floor[r]]
            if min(going, default=_NO_COL) == _NO_COL:
                floor = {r: -1 for r in rows}           # a new sweep
            else:
                least = min(going)
            marked = set()
            for r in rows:
                prev, i = floor[r], cur[r]
                while i < ip[r + 1] and least <= cl[i] < least + window \
                        and cl[i] >= prev:
                    marked.add(cl[i])
                    prev, i = cl[i], i + 1
            for t in sorted(marked):
                staged += 1
                for r in rows:
                    while head(r) == t:
                        visits[r].append(cur[r])
                        acc[:, r] = acc[:, r] + part[:, cur[r]]
                        cur[r] += 1
                        floor[r] = t
    return acc.reshape(B, gm * bm, -1), visits, staged


def _k2q_stream(kind, rng, B, gm, gn, block):
    """A quantized (fp8 e4m3) stream of ``kind`` with per-batch blocks and
    scales: indptr, block_cols, blocks, scales."""
    from repro_torch.core.precision import quantize_blocks
    bm, bk = block
    if kind == "banded":
        half = 3
        mask = np.abs(np.arange(gm)[:, None] * gn // gm
                      - np.arange(gn)[None, :]) <= half
    else:
        mask = rng.random((gm, gn)) < 0.4
    if kind == "empty_rows":
        mask[[0, 5, gm - 1]] = False
    rows = []
    for r in range(gm):
        c = list(np.nonzero(mask[r])[0])
        if kind == "unsorted":
            rng.shuffle(c)
        if kind == "repeated" and c:
            for _ in range(3):          # a column again, beside or later
                i = int(rng.integers(len(c)))
                c.insert(int(rng.integers(i, len(c) + 1)), c[i])
        rows.append(c)
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum([len(c) for c in rows], out=indptr[1:])
    cols = np.array([x for c in rows for x in c], np.int32)
    vals = rng.standard_normal((B, len(cols), bm, bk)).astype(np.float32)
    q, sc = quantize_blocks(torch.from_numpy(vals), torch.float8_e4m3fn)
    return torch.from_numpy(indptr), torch.from_numpy(cols), q, sc


_K2Q_KINDS = ["banded", "random", "unsorted", "repeated", "empty_rows"]


@pytest.mark.parametrize("kind", _K2Q_KINDS)
@pytest.mark.parametrize("block,bn,window", [((8, 8), 128, 1024),
                                             ((8, 8), 128, 4),
                                             ((16, 8), 128, 16),
                                             ((8, 4), 256, 1024)])
def test_k2q_traversal_keeps_each_row_in_stream_order(kind, block, bn,
                                                      window):
    """The K2q kernel's traversal, emulated: every row takes exactly its
    stream slice, in stream order, on banded, 40 %-random, unsorted,
    repeated-column and empty-row streams, at the tuning row's group and
    another, and at windows narrower than a group's columns (more windows
    and sweeps); so its output EQUALS the plain version (B 2, per-batch
    scales).  On ascending rows of distinct columns each K-tile of a group
    is staged once."""
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    rng = np.random.default_rng(_K2Q_KINDS.index(kind) + window)
    B, gm, gn = 2, 19, 24
    indptr, cols, q, sc = _k2q_stream(kind, rng, B, gm, gn, block)
    dense = torch.from_numpy(rng.standard_normal(
        (B, gn * block[1], 40)).astype(np.float32))
    group = tuning.spmm_quant_group(*block, bn)
    got, visits, staged = _emulate_k2q(indptr, cols, q, sc, dense, group,
                                       window)
    ip = indptr.tolist()
    assert visits == [list(range(ip[r], ip[r + 1])) for r in range(gm)]
    assert torch.equal(got, spmm_bcsr_ref(indptr, cols, q, dense,
                                          out_dtype=torch.float32,
                                          scales=sc))
    union = sum(len(set(cols[ip[g]:ip[min(g + group, gm)]].tolist()))
                for g in range(0, gm, group))
    if kind in ("banded", "random", "empty_rows"):
        assert staged == union
    else:
        assert staged >= union
