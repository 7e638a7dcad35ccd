"""Port vs reference: the continuous-batching ``ServeScheduler``, on the CPU.

The port's scheduler admits each queued prompt into the lowest free cache
slot with a single-request prefill, decodes every resident request one
token a step over the occupied slots rounded up to a power-of-two batch
bucket, each row at its own position, and evicts a request at its token
budget or its EOS ("Continuous-batching contract" in ``tests/README.md``).

Held here, on TINY and llama4-scout SMOKE (f32 policy; weights from the
reference's ``init_params`` through ``interop.params_from_jax``, prompts
from numpy seeds):

* per-row decode positions: the vector path ``torch.equal`` to the scalar
  one at equal positions; at unequal positions the reference's
  ``decode_step_layered`` with a pos vector within 1e-4 (logits, as the
  other serving tests), ``decode_attention`` with a (B,) ``kv_len`` within
  1e-6 of its largest value (f32 on both sides), ``route_phase1`` with a
  pos vector exactly (gate within 1e-6);
* greedy tokens equal to the reference's **gather** ``ServeScheduler`` (the
  reference's bcsr serving is red on this jax) at depth 0 and 1 on both of
  the port's backends, and to each request served alone through the port's
  ``ServeLoop``; depth 1 == depth 0 at temperature 0 and 0.7; a
  temperature-0.7 rerun with another slot pool and submit order gives the
  same tokens per uid;
* the batch-bucket law, lowest-slot-first admission, EOS eviction, the
  ``submit`` refusal, the ``decode_step`` overflow backstop, ``attn_mask=``
  (sparse == dense == the reference's), RWKV-6 SMOKE, the ``summary()``
  identities and ``--continuous`` on the CLI.

Tokens are compared exactly, never within a tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.core.masks import AttnMaskSpec as RAttnMaskSpec
from repro.kernels.flash_attention import ops as rfops
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.models.config import ArchConfig as RArchConfig

from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax
from repro_torch.kernels import engine
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)

TINY_KW = dict(
    name="tiny-serve", family="moe", d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"), n_repeats=2,
    head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
MAX_SEQ = 24
N_REQ, LATE_STEP = 5, 2          # requests 3.. arrive after step 2


def _cfgs(name):
    if name == "tiny":
        return RArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
    rcfg = dataclasses.replace(r_get_smoke("llama4-scout-17b-a16e"),
                               policy="f32")
    cfg = dataclasses.replace(configs.get_smoke("llama4-scout-17b-a16e"),
                              policy="f32")
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _build(name):
    rcfg, cfg = _cfgs(name)
    rparams = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    # mixed prompt / budget lengths: the trace that forces join / evict
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10))
                          ).astype(np.int32), int(rng.integers(3, 8)))
            for _ in range(N_REQ)]
    return rcfg, cfg, rparams, params, reqs


@pytest.fixture(scope="module", params=["tiny", "scout-smoke"])
def model(request):
    return _build(request.param)


def _drive(sched, reqs):
    """Three requests at step 0, the rest after step ``LATE_STEP``, then
    until the queue and the slots are empty; {uid: tokens}."""
    for prompt, gen in reqs[:3]:
        sched.submit(prompt, gen)
    late = False
    while sched.has_work():
        sched.step()
        if sched.step_idx == LATE_STEP and not late:
            for prompt, gen in reqs[3:]:
                sched.submit(prompt, gen)
            late = True
    return sched.run()


@functools.lru_cache(maxsize=None)
def _reference_tokens(name):
    """The reference's gather scheduler on the trace (2 slots)."""
    rcfg, _, rparams, _, reqs = _build(name)
    return _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch="gather"), reqs)


def _sched(params, cfg, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return ServeScheduler(params, cfg, device="cpu", **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


# --------------------------------------------------- per-row positions --


@pytest.mark.parametrize("dispatch,depth", [("bcsr", 0), ("bcsr", 1),
                                            ("gather", 0)])
def test_vector_pos_decode_equals_scalar(model, dispatch, depth):
    """A (B,) pos vector whose entries all equal the scalar fill gives the
    scalar path's logits and every cache leaf, ``torch.equal``, through
    the serving stage of the backend (route ahead at depth 1)."""
    _, cfg, _, params, reqs = model
    prompts = torch.from_numpy(np.stack([reqs[0][0][:4], reqs[1][0][:4]]))
    stage = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                      pipeline_depth=depth, device="cpu")
    logits, cache, pos = M.prefill_layered(params, prompts, cfg,
                                           max_seq=MAX_SEQ,
                                           moe_fn=stage._moe_fn())
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    out = {}
    for key, p in (("scalar", pos), ("vector", np.full(2, pos, np.int64))):
        c = _clone(cache)
        lg, same = M.decode_step_layered(params, cfg, c, p, tok,
                                         moe_fn=stage._moe_fn(),
                                         route_ahead=stage._route_ahead())
        assert same is c
        out[key] = (lg, _leaves(c))
    assert torch.equal(out["vector"][0], out["scalar"][0])
    for a, b in zip(out["vector"][1], out["scalar"][1]):
        assert torch.equal(a, b)


def test_per_row_decode_matches_reference(model):
    """Two requests at unequal fills (prefilled alone, caches joined along
    the batch): three decode steps at per-row positions give the
    reference's ``decode_step_layered`` logits within 1e-4 and its MoE
    occupancy exactly."""
    rcfg, cfg, rparams, params, reqs = model
    moe_fn = functools.partial(moe.apply_moe, dispatch="bcsr")
    prompts = [reqs[0][0][:5], reqs[1][0][:8]]
    rc, tc, toks = [], [], []
    for p in prompts:
        rl, rcache, _ = RM.prefill(rparams, jnp.asarray(p[None]), rcfg,
                                   max_seq=MAX_SEQ)
        _, tcache, _ = M.prefill_layered(params, torch.from_numpy(p[None]),
                                         cfg, max_seq=MAX_SEQ, moe_fn=moe_fn)
        rc.append(rcache)
        tc.append(tcache)
        toks.append(int(np.argmax(np.asarray(rl)[0, -1, :cfg.vocab_size])))
    rcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *rc)
    tcache = {"slots": tuple(
        {k: ({kk: torch.cat([a[k][kk], b[k][kk]], dim=1) for kk in a[k]}
             if isinstance(a[k], dict) else torch.cat([a[k], b[k]], dim=1))
         for k in a} for a, b in zip(tc[0]["slots"], tc[1]["slots"]))}
    pos = np.array([len(p) for p in prompts], np.int32)
    tok = np.array(toks, np.int32)[:, None]
    for _ in range(3):
        want, rcache = RM.decode_step_layered(rparams, rcfg, rcache, pos,
                                              jnp.asarray(tok))
        got, tcache = M.decode_step_layered(params, cfg, tcache, pos,
                                            torch.from_numpy(tok).long(),
                                            moe_fn=moe_fn)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        for slot, rslot in zip(tcache["slots"], rcache["slots"]):
            if "moe" in rslot:
                np.testing.assert_array_equal(slot["moe"].numpy(),
                                              np.asarray(rslot["moe"]))
        tok = np.argmax(np.asarray(want)[:, -1, :cfg.vocab_size],
                        -1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention_per_row_kv_len(window):
    """``decode_attention`` with a (B,) ``kv_len`` (and the window's lower
    edge per row) against the reference's, f32, within 1e-6 of the largest
    |value|; at equal lengths the vector is ``torch.equal`` to the int."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, S, D = 3, 4, 2, 16, 16
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    kv_len = np.array([3, 9, 16], np.int32)
    want = np.asarray(rfops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=jnp.asarray(kv_len), window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = fops.decode_attention(tq, tk, tv, kv_len=torch.from_numpy(kv_len),
                                window=window).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    same = fops.decode_attention(tq, tk, tv, kv_len=torch.full((B,), 9),
                                 window=window)
    assert torch.equal(same, fops.decode_attention(tq, tk, tv, kv_len=9,
                                                   window=window))


def test_route_phase1_per_row_matches_reference():
    """``moe.route_phase1`` at per-row positions == the reference's on the
    same h, router and occupancy: flat_slot, keep and new_counts exactly,
    gate within 1e-6; the capacity is the S bound (1 for decode), and at
    equal positions the vector's values are ``torch.equal`` to the int's."""
    rcfg, cfg = _cfgs("tiny")            # capacity factor 1: drops happen
    rng = np.random.default_rng(8)
    d, E = cfg.d_model, cfg.n_experts
    h = rng.normal(size=(4, 1, d)).astype(np.float32)
    router = (rng.normal(size=(d, E)) * d ** -0.5).astype(np.float32)
    counts = rng.integers(0, 4, (4, E)).astype(np.int32)
    pos = np.array([0, 3, 21, 2], np.int32)
    cap = moe.dispatch_capacity(1, cfg, pos0=pos)
    assert cap == rmoe.dispatch_capacity(1, rcfg, pos0=pos) == 1
    assert moe.dispatch_capacity(5, cfg, pos0=torch.from_numpy(pos)) == 5
    want = rmoe.route_phase1(jnp.asarray(router), jnp.asarray(h), rcfg,
                             jnp.asarray(counts), jnp.asarray(pos), cap)
    args = (torch.from_numpy(router), torch.from_numpy(h), cfg,
            torch.from_numpy(counts))
    got = moe.route_phase1(*args, torch.from_numpy(pos), cap)
    gate, keep, new_counts, flat_slot = (np.asarray(w) for w in want)
    np.testing.assert_allclose(got[0].numpy(), gate, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), keep)
    np.testing.assert_array_equal(got[2].numpy(), new_counts)
    np.testing.assert_array_equal(got[3].numpy(), flat_slot)
    assert keep.any() and not keep.all()      # the positions decide
    vec = moe.route_phase1(*args, torch.full((4,), 5, dtype=torch.int32), cap)
    for a, b in zip(vec, moe.route_phase1(*args, 5, cap)):
        assert torch.equal(a, b)


# ----------------------------------------------------- scheduler parity --


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("dispatch", ["bcsr", "gather", "gather-two-phase"])
def test_scheduler_matches_reference_gather(model, dispatch, depth):
    """Staggered arrivals into 2 slots (join, evict, slot reuse): the
    port's greedy tokens per request == the reference's gather
    scheduler's, each request exactly its budget.  Each backend in its
    default mode (bcsr two-phase, gather fused), and gather layered
    (``two_phase=True``)."""
    name = "tiny" if model[1].name == "tiny-serve" else "scout-smoke"
    _, cfg, _, params, reqs = model
    want = _reference_tokens(name)
    kw = {"two_phase": True} if dispatch == "gather-two-phase" else {}
    sched = _sched(params, cfg, max_slots=2,
                   dispatch=dispatch.split("-")[0], pipeline_depth=depth,
                   **kw)
    assert sched.two_phase == (dispatch != "gather")
    got = _drive(sched, reqs)
    assert sorted(got) == sorted(want) == list(range(N_REQ))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
        assert len(got[uid]) == reqs[uid][1]
    assert any(s.extra["active"] == 2 for s in sched.stats
               if s.phase == "decode")               # the pool saturated
    assert len([s for s in sched.stats if s.phase == "prefill"]) == N_REQ


def test_scheduler_matches_serve_loop_alone(model):
    """Greedy, each request's tokens == that request served alone (B = 1)
    through the port's ``ServeLoop`` with the same ``max_seq``."""
    _, cfg, _, params, reqs = model
    got = _drive(_sched(params, cfg, max_slots=2, dispatch="bcsr"), reqs)
    for uid, (prompt, gen) in enumerate(reqs):
        alone = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="bcsr",
                          device="cpu").run(prompt[None], gen)[0]
        np.testing.assert_array_equal(got[uid], alone)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("dispatch", ["bcsr", "gather"])
def test_depth1_equals_depth0(dispatch, temperature):
    """Depth 1 (routes ahead, executes in flight, one token fetch a step)
    gives depth 0's tokens per request, greedy and sampled; its decode
    stats are marked pipelined."""
    _, cfg, _, params, reqs = _build("tiny")
    out = {}
    for depth in (0, 1):
        sched = _sched(params, cfg, max_slots=3, dispatch=dispatch,
                       temperature=temperature, sample_seed=11,
                       pipeline_depth=depth)
        out[depth] = _drive(sched, reqs)
        assert all(s.extra["pipelined"] == bool(depth)
                   for s in sched.stats if s.phase == "decode")
        assert sched.summary()["pipeline"]["depth"] == depth
    assert sorted(out[0]) == sorted(out[1])
    for uid in out[0]:
        np.testing.assert_array_equal(out[1][uid], out[0][uid])


def test_temperature_tokens_follow_the_request():
    """At temperature 0.7 each request samples from its own generator
    (``request_seed(sample_seed, uid)``): a rerun gives the same tokens,
    and so does a rerun with every request queued at once, in the same
    slot pool and in another; the tokens are not the greedy ones."""
    _, cfg, _, params, reqs = _build("tiny")

    def serve_all(max_slots):
        sched = _sched(params, cfg, max_slots=max_slots, temperature=0.7,
                       sample_seed=11, dispatch="bcsr")
        for req in reqs:
            sched.submit(*req)
        return sched.run()

    a = _drive(_sched(params, cfg, max_slots=2, temperature=0.7,
                      sample_seed=11, dispatch="bcsr"), reqs)
    b = serve_all(2)
    c = serve_all(4)
    greedy = _drive(_sched(params, cfg, max_slots=2, dispatch="bcsr"), reqs)
    for uid in range(N_REQ):
        np.testing.assert_array_equal(b[uid], a[uid])
        np.testing.assert_array_equal(c[uid], a[uid])
    assert any(not np.array_equal(a[u], greedy[u]) for u in a)
    assert serve.request_seed(11, 0) != serve.request_seed(11, 1)
    assert serve.request_seed(11, 0) != serve.request_seed(12, 0)


# ------------------------------------------------------------ lifecycle --


def test_batch_bucket_law_and_lowest_slot_admission():
    """The pool is its own bucket (3 slots -> 4 rows); every decode step
    runs on ``batch_bucket(highest occupied slot + 1)`` rows; an admission
    takes the lowest free slot, even with a higher one free."""
    _, cfg, _, params, reqs = _build("tiny")
    sched = _sched(params, cfg, max_slots=3, dispatch="bcsr")
    assert sched.n_slots == 4
    r0 = sched.submit(reqs[0][0], 2)
    r1 = sched.submit(reqs[1][0], 6)
    r2 = sched.submit(reqs[2][0], 4)
    assert sched.admit() == [r0, r1, r2]
    assert [r0.slot, r1.slot, r2.slot] == [0, 1, 2]
    sched.step()
    assert sched.stats[-1].extra == {"batch_bucket": 4, "occupied": 3,
                                     "active": 3, "pipelined": False}
    assert r0.done and r0.slot is None and sched.slots[0] is None
    r3 = sched.submit(reqs[3][0], 3)
    sched.step()
    assert r3.slot == 0                  # slots 0 and 3 were free
    sched.run()
    for s in sched.stats:
        if s.phase == "decode":
            b = s.extra["batch_bucket"]
            assert b == engine.batch_bucket(s.extra["occupied"], cap=4)
            assert s.extra["active"] <= s.extra["occupied"] <= b
    assert sched.batch_buckets <= {1, 2, 4}
    assert 4 in sched.batch_buckets and 2 in sched.batch_buckets


def test_min_bucket_and_f32_cache():
    """``batch_min_bucket=4`` runs every step on at least 4 rows (the pool
    too) and ``cache_dtype=float32`` keeps an f32 K/V cache: the tokens
    are the reference gather scheduler's at the same settings."""
    rcfg, cfg, rparams, params, reqs = _build("tiny")
    want = _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch="gather",
                                  batch_min_bucket=4,
                                  cache_dtype=jnp.float32), reqs)
    sched = _sched(params, cfg, max_slots=2, dispatch="bcsr",
                   batch_min_bucket=4, cache_dtype=torch.float32)
    assert sched.n_slots == 4
    assert sched.cache["slots"][0]["attn"]["k"].dtype == torch.float32
    got = _drive(sched, reqs)
    assert sched.batch_buckets == {4}
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


def test_eos_eviction():
    """A request evicts at its EOS, freeing the slot for the queue; a
    request without one runs its whole budget."""
    _, cfg, _, params, reqs = _build("tiny")
    prompt, _ = reqs[0]
    probe = _sched(params, cfg, max_slots=1, dispatch="bcsr")
    probe.submit(prompt, 5)
    tokens = probe.run()[0]
    eos = int(tokens[2])
    stop = int(np.argmax(tokens == eos)) + 1     # its first occurrence
    sched = _sched(params, cfg, max_slots=1, dispatch="bcsr")
    sched.submit(prompt, 5, eos_id=eos)
    sched.submit(reqs[1][0], 2)
    out = sched.run()
    np.testing.assert_array_equal(out[0], tokens[:stop])
    assert len(out[1]) == 2
    assert [r.state for r in sched.finished] == ["finished"] * 2


def test_submit_refusal_and_overflow_backstop():
    """``submit`` refuses a request that needs more than ``max_seq``
    positions and a budget under 1, and a refused request takes no uid;
    ``decode_step`` raises before a write past the cache."""
    _, cfg, _, params, _ = _build("tiny")
    sched = _sched(params, cfg, max_seq=10, max_slots=1)
    with pytest.raises(ValueError, match="never be served"):
        sched.submit(np.arange(8, dtype=np.int32), 4)
    first = sched.submit(np.arange(8, dtype=np.int32), 3)  # 8 + 3 - 1 fits
    with pytest.raises(ValueError, match="max_new_tokens"):
        sched.submit(np.arange(4, dtype=np.int32), 0)
    sched.queue.clear()
    req = sched.submit(np.arange(4, dtype=np.int32), 2)
    assert (first.uid, req.uid) == (0, 1)
    sched.admit()
    req.pos = sched.max_seq
    with pytest.raises(RuntimeError, match="KV-cache overflow"):
        sched.decode_step()


@pytest.mark.parametrize("dispatch", ["bcsr", "gather"])
def test_attn_mask_sparse_equals_dense(dispatch):
    """``attn_mask=`` (local_global, tiles and window 8) through the
    scheduler: the stream walk gives the masked grid's tokens, both the
    reference gather scheduler's, with no oracle fallback."""
    rcfg, cfg, rparams, params, _ = _build("tiny")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(10, 17))
                          ).astype(np.int32), int(rng.integers(3, 6)))
            for _ in range(4)]
    mask = dict(local=True, pattern="local_global", window=8, bq=8, bk=8)
    rsched = RServeScheduler(rparams, rcfg, max_seq=24, max_slots=2,
                             dispatch="gather",
                             attn_mask=RAttnMaskSpec(**mask, impl="sparse"))
    for prompt, gen in reqs:
        rsched.submit(prompt, gen)
    want = rsched.run()
    for impl in ("sparse", "dense"):
        sched = _sched(params, cfg, max_seq=24, max_slots=2,
                       dispatch=dispatch,
                       attn_mask=AttnMaskSpec(**mask, impl=impl))
        for prompt, gen in reqs:
            sched.submit(prompt, gen)
        got = sched.run()
        assert sched.summary()["timing"]["attention_ref_fallbacks"] == 0
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])


def test_rwkv_scheduler_equals_serve_loop_alone():
    """rwkv6-7b SMOKE (no attention cache, recurrent state per row)
    through the scheduler: each request's greedy tokens == that request
    served alone through ``ServeLoop``; the RWKV leaves stay in the dtypes
    a decode step writes."""
    cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    params = M.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10))
                          ).astype(np.int32), int(rng.integers(3, 7)))
            for _ in range(4)]
    sched = _sched(params, cfg, max_slots=2)
    assert not sched.two_phase
    got = _drive(sched, reqs)
    for leaf in sched.cache["slots"][0].values():
        assert leaf.dtype == torch.float32
    for uid, (prompt, gen) in enumerate(reqs):
        alone = ServeLoop(params, cfg, max_seq=MAX_SEQ,
                          device="cpu").run(prompt[None], gen)[0]
        np.testing.assert_array_equal(got[uid], alone)


def test_summary_identities():
    """``summary()``: decode tokens are the tokens emitted by decode steps
    (every token but each request's first), tok/s is tokens / decode
    seconds, one latency per token and one first-token latency per
    request, the request counts, one route per attn+moe layer per
    admission and per decode step, and the stream buckets those routes
    used."""
    _, cfg, _, params, reqs = _build("tiny")
    sched = _sched(params, cfg, max_slots=2, dispatch="bcsr")
    got = _drive(sched, reqs)
    s = sched.summary()
    n_tok = sum(len(t) for t in got.values())
    n_steps = s["decode"]["calls"]
    assert n_steps == sched.step_idx
    assert s["decode"]["tokens"] == n_tok - N_REQ
    assert s["decode"]["tok_per_s"] == pytest.approx(
        s["decode"]["tokens"] / s["decode"]["seconds"])
    assert s["token_latency_ms"]["n"] == n_tok
    assert s["first_token_ms"]["n"] == N_REQ
    assert s["token_latency_ms"]["p50"] <= s["token_latency_ms"]["p99"]
    assert s["requests"] == {"finished": N_REQ, "queued": 0, "active": 0,
                             "failed": 0, "shed": 0, "retries": 0}
    assert s["prefill"]["calls"] == N_REQ
    n_moe = cfg.n_repeats * cfg.block_unit.count("attn+moe")
    assert s["route"]["calls"] == s["execute"]["calls"] \
        == n_moe * (N_REQ + n_steps)
    routes = [st for st in sched.stats if st.phase == "route"]
    assert s["nnzb_buckets"] == sorted({st.extra["nnzb_stream"]
                                        for st in routes})
    assert all(b == engine.stream_bucket(b) for b in s["nnzb_buckets"])
    assert s["batch_buckets"] == sorted(sched.batch_buckets)
    assert set(s["timing"]) >= {"host_route_ms", "route_hidden_frac"}
    empty = serve._percentiles_ms([None, float("nan")])
    assert empty == {"p50": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}


def test_cli_continuous_on_cpu(capsys):
    args = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--prompt-len",
            "8", "--gen", "4", "--device", "cpu", "--continuous",
            "--requests", "3", "--slots", "2"]
    bcsr = serve.main(args + ["--dispatch", "bcsr"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "[two-phase]" in out
    assert "nnzb buckets" in out and "first token p50" in out
    gather = serve.main(args + ["--dispatch", "gather"])
    piped = serve.main(args + ["--dispatch", "bcsr", "--pipeline-depth", "1"])
    assert "overlap:" in capsys.readouterr().out
    assert sorted(bcsr) == sorted(gather) == sorted(piped) == [0, 1, 2]
    for uid in bcsr:
        np.testing.assert_array_equal(gather[uid], bcsr[uid])
        np.testing.assert_array_equal(piped[uid], bcsr[uid])
