"""Port vs reference: the fused serving mode on the CPU.

``model.prefill`` / ``model.decode_step`` and ``ServeLoop(two_phase=)`` on
llama4-scout SMOKE and rwkv6-7b SMOKE (f32 policy), weights from the
reference's ``init_params`` through ``interop.params_from_jax``, prompts and
tokens from numpy seeds.  On the CPU the fused loop runs
``model.decode_step`` eagerly on its static buffers; on the card the same
step is one replayed CUDA graph (``chip_smoke.py``).

Tolerances, as the other serving tests: logits within 1e-4, the RWKV state
within 2e-5 of its largest |value|.  The port's own laws are ``torch.equal``:
an int, a numpy vector and a device tensor position; the fused and the
layered prefill; full-grid bcsr and gather dispatch.  The reference's bcsr
serving paths raise ``ShardingTypeError`` on this tree's jax 0.9.0, so the
full-grid bcsr path is held against the port's gather and the reference's
gather, which the reference's contract makes bit-identical to its bcsr.
"""
import contextlib
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.serve import ServeLoop as RServeLoop
from repro.models import model as RM

from repro_torch import configs
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.kernels import engine
from repro_torch.kernels.spmm import ref as spmm_ref
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)
SCOUT, RWKV = "llama4-scout-17b-a16e", "rwkv6-7b"
B, PROMPT, GEN = 2, 8, 6
MAX_SEQ = PROMPT + GEN


@functools.lru_cache(maxsize=None)
def _build(arch):
    rcfg = dataclasses.replace(r_get_smoke(arch), policy="f32")
    cfg = dataclasses.replace(configs.get_smoke(arch), policy="f32")
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


@pytest.fixture(scope="module", params=[SCOUT, RWKV])
def model(request):
    return _build(request.param)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


def _all_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


def _from_reference(rcache):
    """A reference decode cache as the port's tree of CPU tensors."""
    return {"slots": tuple({k: (to_tensor(jax.device_get(v))
                                if not isinstance(v, dict) else
                                {kk: to_tensor(jax.device_get(vv))
                                 for kk, vv in v.items()})
                            for k, v in slot.items()}
                           for slot in rcache["slots"])}


def _close(got, want, rel, what):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


def _argmax(logits, cfg):
    return logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)


# ------------------------------------------------------------ entry points --


def test_prefill_matches_reference(model):
    """``M.prefill`` against the reference's ``model.prefill``: logits
    within 1e-4, MoE counts equal; and ``torch.equal`` to the layered
    prefill with one ``apply_moe`` call a layer (the same loop)."""
    rcfg, cfg, rparams, params, prompts = model
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ)
    toks = torch.from_numpy(prompts).long()
    logits, cache, pos = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    assert pos == int(rpos) == PROMPT
    assert tuple(logits.shape) == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rl), atol=1e-4,
                               rtol=0)
    got = jax.tree_util.tree_leaves(rc["slots"])
    assert [str(t.dtype)[6:] for t in _leaves(cache["slots"])] == \
        [str(a.dtype) for a in got]
    for slot, rslot in zip(cache["slots"], rc["slots"]):
        if "moe" in slot:
            np.testing.assert_array_equal(slot["moe"].numpy(),
                                          np.asarray(rslot["moe"]))
    lw, cw, _ = M.prefill_layered(params, toks, cfg, max_seq=MAX_SEQ)
    assert torch.equal(logits, lw) and _all_equal(cache, cw)


def test_prefill_refuses_what_is_not_ported(model):
    """A frontend the reference does not have ("video") raises; frontend
    embeddings (Queue 1 item 1, ported since) are taken: prepended, they
    move the next position past them, fused == layered; ``kv_quant``
    (item 4, ported since) is taken: the logits are the wide prefill's,
    and only the attention caches change (narrow values with f32 scales; a
    stack without attention keeps its cache as it is)."""
    _, cfg, _, params, prompts = model
    toks = torch.from_numpy(prompts).long()
    with pytest.raises(NotImplementedError, match="frontend"):
        M.prefill(params, toks, dataclasses.replace(cfg, frontend="video"),
                  max_seq=MAX_SEQ)
    emb = torch.from_numpy(np.random.default_rng(4).normal(
        0.0, 0.02, (B, 1, cfg.d_model)).astype(np.float32))
    le, ce, pe = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                           embeddings=emb)
    assert pe == PROMPT + 1 and tuple(le.shape) == (B, 1, cfg.padded_vocab)
    ll, cl, _ = M.prefill_layered(params, toks, cfg, max_seq=MAX_SEQ,
                                  embeddings=emb)
    assert torch.equal(le, ll) and _all_equal(ce, cl)
    lw, cw, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    lq, cq, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                          kv_quant="int8")
    assert torch.equal(lq, lw)
    for wide, quant in zip(cw["slots"], cq["slots"]):
        if "attn" in wide:
            assert quant["attn"]["k"].dtype == torch.int8
            assert quant["attn"]["k_scale"].dtype == torch.float32
        else:
            assert _all_equal(quant, wide)


def test_decode_steps_match_reference(model):
    """Three ``M.decode_step`` steps against a jitted reference
    ``decode_step`` from the reference's own prefill cache (so a bf16
    rounding tie that the two prefills broke apart does not count): logits
    within 1e-4, MoE counts equal, the RWKV state within 2e-5.  The step at
    an int position, a (B,) numpy vector, a () tensor and a (B,) tensor
    gives the same logits and cache, ``torch.equal``."""
    rcfg, cfg, rparams, params, prompts = model
    _, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                             max_seq=MAX_SEQ)
    base = M.to_decode_dtypes(cfg, _from_reference(rc))
    kinds = ("int", "vector", "scalar tensor", "row tensor")
    caches = {kind: _clone(base) for kind in kinds}
    step = jax.jit(lambda p, c, q, t: RM.decode_step(p, rcfg, c, q, t))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, B, 1))
    for i, tok in enumerate(toks):
        rl, rc = step(rparams, rc, jnp.asarray(int(rpos) + i, jnp.int32),
                      jnp.asarray(tok, jnp.int32))
        p = int(rpos) + i
        where = {"int": p, "vector": np.full(B, p, np.int64),
                 "scalar tensor": torch.tensor(p),
                 "row tensor": torch.full((B,), p, dtype=torch.int32)}
        out = {}
        for kind in kinds:
            out[kind], same = M.decode_step(params, cfg, caches[kind],
                                            where[kind],
                                            torch.from_numpy(tok).long())
            assert same is caches[kind]
        np.testing.assert_allclose(out["int"].numpy(), np.asarray(rl),
                                   atol=1e-4, rtol=0)
        for kind in kinds[1:]:
            assert torch.equal(out[kind], out["int"]), kind
    for kind in kinds[1:]:
        assert _all_equal(caches[kind], caches["int"]), kind
    for slot, rslot, kind in zip(caches["int"]["slots"], rc["slots"],
                                 cfg.block_unit):
        if kind == "rwkv":
            for key in ("wkv", "shift_t", "shift_c"):
                assert slot[key].dtype == torch.float32
                _close(slot[key], rslot[key], 2e-5, key)
        if "moe" in slot:
            np.testing.assert_array_equal(slot["moe"].numpy(),
                                          np.asarray(rslot["moe"]))


def test_decode_step_refusals(model):
    """A cache not in the step's dtypes, a position of the wrong shape or
    device, and (with attention) an int position past the cache: each
    raises before the step writes anything."""
    _, cfg, _, params, prompts = model
    _, cache, pos = M.prefill(params, torch.from_numpy(prompts).long(), cfg,
                              max_seq=MAX_SEQ)
    tok = torch.zeros((B, 1), dtype=torch.long)
    if "rwkv" in cfg.block_unit:
        with pytest.raises(ValueError, match="to_decode_dtypes"):
            M.decode_step(params, cfg, cache, pos, tok)
    M.to_decode_dtypes(cfg, cache)
    before = _clone(cache)
    for bad in (torch.zeros(B + 1, dtype=torch.long),
                torch.zeros((B, 1), dtype=torch.long), torch.tensor(1.0)):
        with pytest.raises(ValueError, match="pos"):
            M.decode_step(params, cfg, cache, bad, tok)
    if "attn" in cfg.block_unit or "attn+moe" in cfg.block_unit:
        with pytest.raises(ValueError, match="overflow"):
            M.decode_step(params, cfg, cache, MAX_SEQ, tok)
    assert _all_equal(cache, before)


# ------------------------------------------------------- full-grid bcsr --


def test_full_grid_stream_covers_the_grid():
    """The full-grid stream of one layer, with tokens dropped: every block
    of the (gm, gn) grid in (row, col) order, ``indptr`` ``gn`` a row, its
    blocks the routed stream's dispatch matrix; ``apply_moe`` through it
    ``torch.equal`` to gather, and the index stream built once a grid."""
    cfg = ArchConfig(name="tiny-fused", family="moe", d_model=32, n_heads=2,
                     n_kv_heads=1, d_ff=48, vocab_size=64,
                     block_unit=("attn+moe",), n_repeats=1, head_dim=16,
                     n_experts=16, top_k=1, capacity_factor=0.5,
                     moe_shared_expert=True, policy="f32")
    p = M._take(moe.init_moe(torch.Generator().manual_seed(0), cfg, n=1,
                             dtype=torch.float32, device="cpu"), 0)
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 40, cfg.d_model)).astype(np.float32))
    seen = []
    entry = engine.spmm_batched_stream

    def keep(a, dense, **kw):
        seen.append(a)
        return entry(a, dense, **kw)

    engine.spmm_batched_stream = keep
    try:
        grid, counts = moe.apply_moe(p, x, cfg, dispatch="bcsr",
                                     full_grid=True)
    finally:
        engine.spmm_batched_stream = entry
    want, want_counts = moe.apply_moe(p, x, cfg, dispatch="gather")
    assert torch.equal(grid, want) and torch.equal(counts, want_counts)
    plan, _ = moe.route_moe(p, x, cfg, dispatch="gather")
    assert not plan.keep.all()              # the capacity drops tokens
    a = seen[0]
    gm, gn = a.grid_shape
    assert a.nnzb == gm * gn
    assert torch.equal(a.indptr, torch.arange(gm + 1, dtype=torch.int32) * gn)
    assert torch.equal(a.block_rows.long(),
                       torch.arange(gm * gn) // gn)
    assert torch.equal(a.block_cols.long(), torch.arange(gm * gn) % gn)
    bm, bk = a.block
    routed, _, _ = moe._build_routed_stream(
        plan.flat_slot.numpy(), x.shape[1], cfg.n_experts, plan.capacity,
        bm, bk, torch.float32, "cpu")

    def dense(s):
        out = torch.zeros(s.shape)
        for i in range(s.nnzb):
            r, c = int(s.block_rows[i]), int(s.block_cols[i])
            out[:, r * bm:(r + 1) * bm, c * bk:(c + 1) * bk] += s.blocks[:, i]
        return out

    assert a.shape == routed.shape
    assert torch.equal(dense(a), dense(routed))
    assert moe._grid_index(gm, gn, x.device)[0] is a.indptr
    # the kernel takes contiguous operands only: at a decode step too,
    # where the grid is one block column (gn 1) of two block rows
    step, _ = moe.route_moe(p, x[:, :1], cfg, dispatch="bcsr", full_grid=True,
                            pos=torch.full((3,), 40))
    assert step.stream.grid_shape == (2, 1)
    for s in (a, step.stream):
        assert all(t.is_contiguous() for t in (s.indptr, s.block_rows,
                                               s.block_cols, s.blocks))


def test_full_grid_bcsr_equals_gather():
    """Fused bcsr (the full-grid stream) and fused gather: prefill logits,
    three decode steps' logits and every cache leaf ``torch.equal``; both
    within 1e-4 of the reference's fused gather prefill."""
    rcfg, cfg, rparams, params, prompts = _build(SCOUT)
    toks = torch.from_numpy(prompts).long()
    out = {}
    for dispatch in ("gather", "bcsr"):
        logits, cache, pos = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                       dispatch=dispatch)
        M.to_decode_dtypes(cfg, cache)
        steps = [logits]
        for i in range(3):
            tok = _argmax(steps[-1], cfg)
            steps.append(M.decode_step(params, cfg, cache,
                                       torch.tensor(pos + i), tok,
                                       dispatch=dispatch)[0])
        out[dispatch] = steps, cache
    for a, b in zip(out["gather"][0], out["bcsr"][0]):
        assert torch.equal(a, b)
    assert _all_equal(out["gather"][1], out["bcsr"][1])
    rl, _, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                          max_seq=MAX_SEQ)
    np.testing.assert_allclose(out["bcsr"][0][0].numpy(), np.asarray(rl),
                               atol=1e-4, rtol=0)


# ----------------------------------------------------------- no host read --


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor reaches the host (``item``, ``tolist``,
    ``numpy``, ``cpu``, ``int()``, ``float()``, ``bool()``, use as an
    index) raises, except inside the plain version of K2
    (``spmm_bcsr_ref``): it stands on the CPU for the kernel, which never
    reads the stream on the host (``engine.spmm_batched_stream``)."""
    names = ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
             "__float__", "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    plain = spmm_ref.spmm_bcsr_ref.__code__

    def guard(name):
        def read(self, *a, **kw):
            f = sys._getframe(1)
            while f is not None and f.f_code is not plain:
                f = f.f_back
            if f is None:
                raise AssertionError(f"host read: Tensor.{name}")
            return saved[name](self, *a, **kw)
        return read

    for n in names:
        setattr(torch.Tensor, n, guard(n))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)


@pytest.mark.parametrize("arch,dispatch", [(SCOUT, "gather"),
                                           (SCOUT, "bcsr"), (RWKV, None)])
def test_device_position_step_reads_nothing_on_the_host(arch, dispatch):
    """``M.decode_step`` at a device position tensor makes no host read,
    gather and full-grid bcsr; the guard itself catches one."""
    _, cfg, _, params, prompts = _build(arch)
    logits, cache, pos = M.prefill(params, torch.from_numpy(prompts).long(),
                                   cfg, max_seq=MAX_SEQ, dispatch=dispatch)
    M.to_decode_dtypes(cfg, cache)
    tok, where = _argmax(logits, cfg), torch.tensor(pos)
    want, _ = M.decode_step(params, cfg, _clone(cache), where, tok,
                            dispatch=dispatch)
    with _no_host_reads():
        got, _ = M.decode_step(params, cfg, cache, where, tok,
                               dispatch=dispatch)
        with pytest.raises(AssertionError, match="host read"):
            int(where)
    assert torch.equal(got, want)


# -------------------------------------------------------------- ServeLoop --


@pytest.mark.parametrize("arch,dispatch", [(SCOUT, "gather"),
                                           (SCOUT, "bcsr"), (RWKV, None),
                                           (RWKV, "bcsr")])
def test_default_two_phase_is_the_reference(arch, dispatch):
    rcfg, cfg, rparams, params, _ = _build(arch)
    for two_phase in (None, True, False):
        want = RServeLoop(rparams, rcfg, max_seq=MAX_SEQ, dispatch=dispatch,
                          two_phase=two_phase).two_phase
        got = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                        two_phase=two_phase, device="cpu").two_phase
        assert got == want, two_phase
    assert want is False and (
        ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                  device="cpu").two_phase
        == (dispatch == "bcsr" and arch == SCOUT))


def test_fused_tokens_match_reference(model):
    """The default loop (fused for scout's gather and for RWKV) gives the
    reference's default loop's greedy tokens, and so does fused bcsr; the
    step is made once a batch and reused by the next run."""
    rcfg, cfg, rparams, params, prompts = model
    want = np.asarray(RServeLoop(rparams, rcfg, max_seq=MAX_SEQ).run(
        jnp.asarray(prompts), GEN))
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    assert not loop.two_phase
    np.testing.assert_array_equal(loop.run(prompts, GEN), want)
    s = loop.summary()
    assert s["capture"] == {"calls": 0, "ms": 0.0}          # no graph on CPU
    assert "route" not in s and s["decode"]["calls"] == GEN - 1
    step = loop.fused_step
    assert loop.cache is step.cache
    np.testing.assert_array_equal(loop.run(prompts, GEN), want)
    assert loop.fused_step is step and len(loop._fused) == 1
    fused_bcsr = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="bcsr",
                           two_phase=False, device="cpu")
    np.testing.assert_array_equal(fused_bcsr.run(prompts, GEN), want)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("arch,dispatch", [(SCOUT, "gather"),
                                           (SCOUT, "bcsr"), (RWKV, None)])
def test_fused_equals_layered_at_temperature(arch, dispatch, depth):
    """Fused and ``two_phase=True`` loops sample the same tokens at
    temperature 0.7 with the same seed, at depths 0 and 1; a fused depth-1
    run's steps are dispatch-only and end with one drain."""
    _, cfg, _, params, prompts = _build(arch)
    kw = dict(max_seq=MAX_SEQ, dispatch=dispatch, temperature=0.7,
              sample_seed=7, pipeline_depth=depth, device="cpu")
    want = ServeLoop(params, cfg, two_phase=True, **kw).run(prompts, GEN)
    loop = ServeLoop(params, cfg, two_phase=False, **kw)
    np.testing.assert_array_equal(loop.run(prompts, GEN), want)
    s = loop.summary()
    if depth:
        assert s["drain"]["calls"] == 1
        assert all(st.extra["dispatch_only"] for st in loop.stats
                   if st.phase == "decode")
    assert "route" not in s and "execute" not in s


def test_overflow_refused_before_any_write(model):
    """A fused decode step past ``max_seq`` raises before it writes: the
    cache, the position and token buffers and the tokens are unchanged."""
    _, cfg, _, params, prompts = model
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    loop.run(prompts, MAX_SEQ - PROMPT + 1)    # the last write at MAX_SEQ - 1
    fused = loop.fused_step
    state = _clone((loop.cache["slots"], fused.pos, fused.tokens))
    n = len(loop.generated)
    with pytest.raises(RuntimeError, match="overflow"):
        loop.decode_step()
    assert _all_equal(state, (loop.cache["slots"], fused.pos, fused.tokens))
    assert len(loop.generated) == n


def test_cli_two_phase_flag(capsys):
    args = ["--arch", SCOUT, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "4", "--device", "cpu", "--dispatch", "bcsr"]
    on = serve.main(args + ["--two-phase", "on"])
    assert "[two-phase]" in capsys.readouterr().out
    off = serve.main(args + ["--two-phase", "off"])
    assert "[fused, capture 0.0 ms]" in capsys.readouterr().out
    np.testing.assert_array_equal(on, off)
    np.testing.assert_array_equal(serve.main(args), on)     # auto: bcsr on
    assert "[two-phase]" in capsys.readouterr().out
