"""Port vs reference: pipelined serving (``pipeline_depth=1``), on the CPU.

The port's ``ServeLoop(pipeline_depth=1)`` runs route phase 1 with each
attn+moe layer's attention half (``route_ahead``), leaves each execute in
flight in ``engine.StreamPipeline`` behind the next layer's host route, and
makes no per-step host sync.  It must give the tokens of depth 0, on both
dispatch backends, greedy and at temperature 0.7, at TINY and scout-SMOKE
(f32), and its bcsr tokens must equal the reference's gather
``ServeLoop(pipeline_depth=1)`` (the reference's bcsr serving is red on this
jax).  Weights come from the reference's ``init_params`` through
``interop.params_from_jax``; prompts from a numpy seed.  Also held: the
pipeline's depth semantics and exception safety, ``route_ahead`` against
``route_ahead=False`` (``torch.equal``), ``moe.route_phase1`` against the
reference's, and the reference's accounting laws of ``summary()["timing"]``
("Pipelined serving contract" in ``tests/README.md``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.serve import ServeLoop as RServeLoop
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.models.config import ArchConfig as RArchConfig

from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels import engine
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)

TINY_KW = dict(
    name="tiny-serve", family="moe", d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"), n_repeats=2,
    head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
B, PROMPT, GEN = 2, 8, 6
MAX_SEQ = PROMPT + GEN


def _cfgs(name):
    if name == "tiny":
        return RArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
    rcfg = dataclasses.replace(r_get_smoke("llama4-scout-17b-a16e"),
                               policy="f32")
    cfg = dataclasses.replace(configs.get_smoke("llama4-scout-17b-a16e"),
                              policy="f32")
    return rcfg, cfg


@pytest.fixture(scope="module", params=["tiny", "scout-smoke"])
def model(request):
    rcfg, cfg = _cfgs(request.param)
    rparams = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (B, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


def _loop(params, cfg, **kw):
    return ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu", **kw)


# ------------------------------------------------------- StreamPipeline --


def test_stream_pipeline_depth_semantics():
    """Depth 0 waits on push; depth 1 keeps exactly one entry in flight;
    drain() empties either; a CPU handle is never busy; depth 2 raises."""
    pipe0 = engine.StreamPipeline(0)
    pipe0.push("a", torch.ones(4) * 2)
    assert len(pipe0) == 0
    pipe1 = engine.StreamPipeline(1)
    pipe1.push("a", torch.ones(4))
    assert len(pipe1) == 1 and not pipe1.busy()
    pipe1.push("b", torch.ones(4) * 3)
    assert len(pipe1) == 1
    pipe1.drain()
    assert len(pipe1) == 0 and not pipe1.busy()
    assert pipe1.pushes == 2
    for depth in (2, -1):
        with pytest.raises(ValueError):
            engine.StreamPipeline(depth)


@pytest.mark.parametrize("case", ["push", "drain", "abort"])
def test_stream_pipeline_failing_wait_empties_queue(monkeypatch, case):
    """A wait that raises (a deferred device error) leaves the queue empty:
    push and drain re-raise it, abort swallows it."""
    calls = []

    def failing_wait(event):
        calls.append(event)
        raise RuntimeError("deferred device error")

    pipe = engine.StreamPipeline(1)
    pipe.push("a", torch.ones(4))
    monkeypatch.setattr(engine, "_wait", failing_wait)
    if case == "abort":
        pipe.abort()
    else:
        with pytest.raises(RuntimeError, match="deferred"):
            if case == "push":
                pipe.push("b", torch.ones(4))
            else:
                pipe.drain()
    assert len(pipe) == 0 and calls


# ------------------------------------------------------ ServeLoop parity --


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("dispatch", ["bcsr", "gather"])
def test_depth1_tokens_equal_depth0(model, dispatch, temperature):
    """Depth 1 gives depth 0's tokens.  Its run ends with one drain stat,
    every decode step and every decode execute is dispatch-only, and the
    attention half is never drained before a route."""
    _, cfg, _, params, prompts = model
    kw = dict(dispatch=dispatch, temperature=temperature, sample_seed=7)
    want = _loop(params, cfg, **kw).run(prompts, GEN)
    loop = _loop(params, cfg, pipeline_depth=1, **kw)
    got = loop.run(prompts, GEN)
    np.testing.assert_array_equal(got, want)
    s = loop.summary()
    assert s["pipeline"]["depth"] == 1 and s["drain"]["calls"] == 1
    assert s["decode"]["calls"] == GEN - 1 and s["decode"]["tok_per_s"] > 0
    decode = [st for st in loop.stats if st.phase == "decode"]
    assert len(decode) == GEN - 1
    assert all(st.extra["dispatch_only"] for st in decode)
    execs = [st for st in loop.stats if st.phase == "execute"]
    assert len(execs) == (GEN * cfg.n_repeats
                          * cfg.block_unit.count("attn+moe")
                          if dispatch == "bcsr" else 0)
    assert all(st.extra["dispatch_only"] for st in execs)
    assert all(st.extra["drain_s"] == 0.0 and st.extra["pipelined"]
               for st in loop.stats if st.phase == "route")


def test_bcsr_depth1_matches_reference_gather_depth1(model):
    """The port's pipelined two-phase loop gives the reference's pipelined
    gather loop's greedy tokens."""
    rcfg, cfg, rparams, params, prompts = model
    want = RServeLoop(rparams, rcfg, max_seq=MAX_SEQ, dispatch="gather",
                      pipeline_depth=1).run(jnp.asarray(prompts), GEN)
    got = _loop(params, cfg, dispatch="bcsr", pipeline_depth=1).run(prompts,
                                                                   GEN)
    np.testing.assert_array_equal(got, want)


def test_rwkv_depth1_tokens_equal_depth0():
    """A stack without attn+moe layers (rwkv6-7b SMOKE) takes the depth-1
    decode too: no route, dispatch-only steps, one drain, the same
    tokens."""
    cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 12))
    want = ServeLoop(params, cfg, max_seq=12 + GEN, device="cpu").run(
        prompts, GEN)
    loop = ServeLoop(params, cfg, max_seq=12 + GEN, pipeline_depth=1,
                     device="cpu")
    np.testing.assert_array_equal(loop.run(prompts, GEN), want)
    s = loop.summary()
    assert s["drain"]["calls"] == 1 and "route" not in s
    assert all(st.extra["dispatch_only"] for st in loop.stats
               if st.phase == "decode")


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_sampler_draws_multinomial_tokens(temperature):
    """``serve.sample_tokens`` is ``torch.multinomial``'s one-sample path
    (argmax at temperature 0): the same generator use, the same tokens."""
    logits = torch.from_numpy(
        np.random.default_rng(6).normal(size=(5, 3, 70)).astype(np.float32))
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    for step in range(3):
        lg = logits[:, step]
        got = serve.sample_tokens(lg, 64, temperature, g1)
        if temperature > 0:
            probs = torch.softmax(lg[:, :64] / temperature, dim=-1)
            want = torch.multinomial(probs, 1, generator=g2)
        else:
            want = torch.argmax(lg[:, :64], dim=-1, keepdim=True)
        assert got.dtype == torch.int32
        assert torch.equal(got.long(), want)


# ------------------------------------------------- route ahead, phase 1 --


def _stage(seen):
    """A two-phase MoE stage that records whether phase 1 came ahead."""
    def fn(p, h, cfg, counts=None, pos=None, phase1=None):
        seen.append(phase1 is not None)
        if phase1 is None:
            plan, _ = moe.route_moe(p, h, cfg, counts=counts, pos=pos,
                                    dispatch="bcsr")
        else:
            plan, _ = moe.plan_from_phase1(phase1, cfg, dispatch="bcsr",
                                           dtype=h.dtype)
        return moe.execute_moe(p, h, plan, cfg)
    return fn


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_route_ahead_equals_route_behind(model):
    """``route_ahead=True`` in prefill and in a decode step gives logits and
    caches ``torch.equal`` to ``route_ahead=False``, and hands every
    attn+moe block its phase 1."""
    _, cfg, _, params, prompts = model
    toks = torch.from_numpy(prompts).long()
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    out = {}
    for ahead in (False, True):
        seen = []
        logits, cache, pos = M.prefill_layered(
            params, toks, cfg, max_seq=MAX_SEQ, moe_fn=_stage(seen),
            route_ahead=ahead)
        nxt = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        dlogits, cache = M.decode_step_layered(
            params, cfg, cache, pos, nxt, moe_fn=_stage(seen),
            route_ahead=ahead)
        assert seen == [ahead] * (2 * n_moe)
        out[ahead] = (logits, dlogits, _leaves(cache))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert len(out[True][2]) == len(out[False][2])
    for a, b in zip(out[True][2], out[False][2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_route_phase1_matches_reference(case):
    """``moe.route_phase1`` == the reference's ``route_phase1`` on the same
    h, router and occupancy: flat_slot, keep and new_counts exactly, gate
    within 1e-6 (f32 router matmul and softmax on both sides)."""
    rcfg, cfg = _cfgs("scout-smoke")
    rng = np.random.default_rng(8)
    S, pos0 = (16, 0) if case == "prefill" else (1, 21)
    d, E = cfg.d_model, cfg.n_experts
    h = rng.normal(size=(4, S, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) * d ** -0.5).astype(np.float32)
    counts = (None if case == "prefill" else
              rng.integers(0, 4, (4, E)).astype(np.int32))
    cap = moe.dispatch_capacity(S, cfg, pos0=pos0)
    rcounts, tcounts = ((None, None) if counts is None else
                        (jnp.asarray(counts), torch.from_numpy(counts)))
    want = rmoe.route_phase1(jnp.asarray(router), jnp.asarray(h), rcfg,
                             rcounts, pos0, cap)
    got = moe.route_phase1(torch.from_numpy(router), torch.from_numpy(h), cfg,
                           tcounts, pos0, cap)
    gate, keep, new_counts, flat_slot = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), gate, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), keep)
    np.testing.assert_array_equal(got[2].numpy(), new_counts)
    np.testing.assert_array_equal(got[3].numpy(), flat_slot)
    assert (got[3].numpy() < E * cap).any()      # some token is kept


# --------------------------------------------------- overlap accounting --


def test_serial_mode_has_zero_hidden_route(model):
    """Depth 0: no route time is hidden, no execute is dispatch-only, no
    drain stat; the route stats carry the depth-1 keys at their zeros."""
    _, cfg, _, params, prompts = model
    loop = _loop(params, cfg, dispatch="bcsr")
    loop.run(prompts, GEN)
    s = loop.summary()
    tm = s["timing"]
    assert s["pipeline"]["depth"] == 0 and "drain" not in s
    assert tm["route_hidden_frac"] == tm["route_hidden_ms"] == 0.0
    assert tm["execute_dispatch_ms"] == 0.0
    for st in loop.stats:
        if st.phase == "route":
            assert st.extra["hidden_s"] == 0.0 and not st.extra["pipelined"]
        if st.phase == "execute":
            assert not st.extra["dispatch_only"]
        if st.phase == "decode":
            assert "dispatch_only" not in st.extra


def test_pipelined_overlap_accounting_bounds(model):
    """Depth 1: hidden route time is part of the route's fetch wait
    (hidden_s <= wait_s on every route stat, so route_hidden_frac is in
    [0, 1]), and no execute wall is a waited one."""
    _, cfg, _, params, prompts = model
    loop = _loop(params, cfg, dispatch="bcsr", pipeline_depth=1)
    loop.run(prompts, GEN)
    tm = loop.summary()["timing"]
    assert 0.0 <= tm["route_hidden_frac"] <= 1.0
    assert tm["route_hidden_ms"] <= tm["route_wait_ms"] + 1e-9
    assert tm["device_execute_ms"] == 0.0 and tm["attn_drain_ms"] == 0.0
    for st in loop.stats:
        if st.phase == "route":
            assert 0.0 <= st.extra["hidden_s"] <= st.extra["wait_s"]


@pytest.mark.parametrize("depth", [0, 1])
def test_timing_attribution_identities(model, depth):
    """The split is exact by construction: host + wait == route, and the
    execute phase is ``device_execute_ms`` at depth 0 and
    ``execute_dispatch_ms`` at depth 1; the timing has the reference's
    eight keys."""
    _, cfg, _, params, prompts = model
    loop = _loop(params, cfg, dispatch="bcsr", pipeline_depth=depth)
    loop.run(prompts, GEN)
    s = loop.summary()
    tm = s["timing"]
    assert set(tm) == {"host_route_ms", "route_wait_ms", "attn_drain_ms",
                       "device_execute_ms", "execute_dispatch_ms",
                       "route_hidden_ms", "route_hidden_frac",
                       "attention_ref_fallbacks"}
    assert (tm["host_route_ms"] + tm["route_wait_ms"]) / 1e3 == \
        pytest.approx(s["route"]["seconds"], rel=1e-9)
    key = "device_execute_ms" if depth == 0 else "execute_dispatch_ms"
    assert tm[key] / 1e3 == pytest.approx(s["execute"]["seconds"], rel=1e-9)


# ------------------------------------------------------- guards and CLI --


def test_loop_refuses_bad_depth_and_params_off_its_device():
    """``ServeLoop`` rejects a depth outside {0, 1} (through
    ``StreamPipeline``) and any param, not only the embedding, that lies off
    the loop's device -- so a loop never runs its steps on tensors of
    another device."""
    _, cfg = _cfgs("tiny")
    params = M.init_params(cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="depth"):
        _loop(params, cfg, pipeline_depth=2)
    blocks = list(params["blocks"])
    blocks[1] = {**blocks[1], "ffn": {**blocks[1]["ffn"], "router":
                 torch.empty(blocks[1]["ffn"]["router"].shape,
                             device="meta")}}
    with pytest.raises(ValueError, match="meta"):
        _loop({**params, "blocks": tuple(blocks)}, cfg)


def test_cli_pipeline_depth_1_on_cpu(capsys):
    args = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--device", "cpu",
            "--dispatch", "bcsr"]
    serial = serve.main(args)
    capsys.readouterr()
    piped = serve.main(args + ["--pipeline-depth", "1"])
    out = capsys.readouterr().out
    assert "pipeline depth 1: drain" in out and "route_hidden_frac" in out
    np.testing.assert_array_equal(piped, serial)
    with pytest.raises(SystemExit):
        serve.main(args + ["--pipeline-depth", "2"])
