"""Port vs reference: serving resilience (``repro_torch.runtime.resilience``
and the drivers' hooks), on the CPU.

The contract is the reference's ("Resilience contract" in
``tests/README.md``): with any single injected fault, every surviving
request's tokens equal the same trace served without it; poison stays in
its row; host failures retry from the state the first try started from;
the health bits ride the step's one token fetch.  The reference's bcsr
runs raise ``ShardingTypeError`` on this tree's jax, so the port's hooks
are held against the reference's two-phase **gather** scheduler (its
``_moe_two_phase``, the same hook calls as bcsr): ``plan.triggered`` of a
port run, on either backend and in either mode, equals the reference's
under the same plan.

Held here, on the reference's TINY config (weights from its
``init_params`` through ``interop.params_from_jax``; prompts from numpy
seeds) and rwkv6-7b SMOKE (f32 policy):

* the registry, the policies and the ladder: spec validation,
  ``poison_rows``, ``times`` / ``reset``, selectors, exception and
  straggler, ``FaultPlan.random``'s specs == the reference's for seeds 0-2,
  the retry schedule, the ladder's order, threshold and ``for_serving``,
  ``HealthTracker``;
* the cache helpers against the reference's on the same quantized cache:
  ``dequantize_cache``, ``blank_cache_row`` and ``corrupt_quant_scales``
  (the last two in place: same storage, other rows untouched);
* the reference's ``MATRIX`` and ``CROSS`` fault plans on the port:
  two-phase bcsr and gather at depths 0 and 1, fused gather and bcsr --
  survivors' tokens == the port's fault-free run, the reference's failed
  uids and ``triggered``; fault-free tokens == the reference's;
* a retried decode step leaves the slot pool ``torch.equal`` to the
  fault-free run's: an ``execute`` exception at ``layer=1`` two-phase (the
  first MoE layer's occupancy already written) and a ``sample`` exception
  after a fused rwkv6-7b step (every layer's state already stepped); with
  the save patched out both diverge, so the check is not vacuous;
* ``ServeLoop``: poison stays in its row and ``rows_finite`` says so; an
  exception releases the pipeline and the loop serves on;
* retry, backoff, exhaustion; deadlines on a fake clock; the bounded queue;
  the ladder's rungs (fused ``kv_wide`` rebuilds every bucket's step on an
  f32 pool); host reads of a step with a plan attached.

Tokens and pool leaves are compared exactly, never within a tolerance.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models.config import ArchConfig as RArchConfig
from repro.runtime import resilience as RR

from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.kernels.spmm import ref as spmm_ref
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import resilience as R

torch.set_num_threads(2)

TINY_KW = dict(
    name="tiny-resilience", family="moe", d_model=32, n_heads=2,
    n_kv_heads=1, d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"),
    n_repeats=2, head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
PROMPT, GEN, MAX_SEQ = 8, 5, 16
N_REQ, SLOTS = 3, 2


@functools.lru_cache(maxsize=None)
def _build(name="tiny"):
    if name == "tiny":
        rcfg, cfg = RArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
    else:
        rcfg = dataclasses.replace(r_get_smoke("rwkv6-7b"), policy="f32")
        cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT) for _ in range(N_REQ)]
    return rcfg, cfg, rparams, params, prompts


def _sched(name="tiny", *, dispatch="bcsr", depth=0, two_phase=True,
           plan=None, kv_quant=None, **kw):
    _, cfg, _, params, _ = _build(name)
    kw.setdefault("max_slots", SLOTS)
    return ServeScheduler(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                          two_phase=two_phase, cache_dtype=torch.float32,
                          pipeline_depth=depth, kv_quant=kv_quant,
                          fault_plan=plan, device="cpu", **kw)


def _run(name="tiny", **kw):
    sched = _sched(name, **kw)
    for p in _build(name)[4]:
        sched.submit(p, GEN)
    return sched, sched.run()


@functools.lru_cache(maxsize=None)
def _baseline(dispatch, depth, two_phase, kv_quant, name="tiny"):
    """The port's fault-free tokens of the trace in this mode."""
    return _run(name, dispatch=dispatch, depth=depth, two_phase=two_phase,
                kv_quant=kv_quant)[1]


def _specs_key(specs):
    return tuple(dataclasses.astuple(s) for s in specs)


@functools.lru_cache(maxsize=None)
def _reference(specs_key, kv_quant):
    """The reference's two-phase gather scheduler (depth 0) on the trace
    under the same plan: (tokens, failed uids, triggered)."""
    rcfg, _, rparams, _, prompts = _build()
    plan = (RR.FaultPlan([RR.FaultSpec(*s) for s in specs_key])
            if specs_key else None)
    sched = RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ, max_slots=SLOTS,
                            dispatch="gather", two_phase=True,
                            cache_dtype=jnp.float32, kv_quant=kv_quant,
                            fault_plan=plan)
    for p in prompts:
        sched.submit(p, GEN)
    out = sched.run()
    return (out, {r.uid for r in sched.failed},
            list(plan.triggered) if plan is not None else [])


def _assert_survivors(out, base, failed=()):
    for uid, toks in base.items():
        if uid in failed:
            continue
        assert uid in out, f"survivor {uid} missing from the faulted run"
        np.testing.assert_array_equal(out[uid], toks,
                                      err_msg=f"survivor {uid} diverged")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# --------------------------------------------------------- fault registry --

class TestFaultPlan:
    def test_spec_validation(self):
        with pytest.raises(ValueError, match="stage"):
            R.FaultSpec(stage="nope", kind="nan")
        with pytest.raises(ValueError, match="kind"):
            R.FaultSpec(stage="sample", kind="nope")
        with pytest.raises(ValueError, match="quantize"):
            R.FaultSpec(stage="quantize", kind="exception")
        with pytest.raises(ValueError, match="quantize"):
            R.FaultSpec(stage="quantize", kind="straggler")

    def test_poison_rows(self):
        x = torch.ones((4, 3, 2))
        y = R.poison_rows(x, [1, 3], "nan")
        assert y.isnan()[[1, 3]].all() and (y[[0, 2]] == 1.0).all()
        z = R.poison_rows(x.bfloat16(), [0], "inf")
        assert z.dtype == torch.bfloat16
        assert z[0].isinf().all() and (z[1:] == 1.0).all()
        assert R.poison_rows(x, [], "nan") is x
        assert (x == 1.0).all()                       # never in place

    def test_times_and_reset(self):
        plan = R.FaultPlan.single("sample", "nan", times=2)
        x = torch.ones((2, 4))
        for _ in range(3):
            plan.apply("sample", x, step=0)
        assert len(plan.triggered) == 2
        plan.reset()
        assert plan.triggered == [] and len(plan._armed(
            "sample", step=None, layer=0)) == 1

    def test_selectors(self):
        plan = R.FaultPlan.single("execute", "nan", uid=7, step=3)
        x = torch.ones((2, 4))
        assert plan.apply("execute", x, step=2, uids=[7, None]) is x
        assert plan.apply("execute", x, step=3, uids=[1, 2]) is x
        y = plan.apply("execute", x, step=3, uids=[1, 7])
        assert y[1].isnan().all() and (y[0] == 1).all()
        assert plan.triggered == [("execute", "nan", 3, (1,))]
        rows = R.FaultPlan.single("sample", "inf", row=1)
        assert rows.apply("sample", torch.ones(1, 2)).isfinite().all()
        assert rows.apply("sample", x)[1].isinf().all()

    def test_layer_counts_calls_per_stage_and_step(self):
        plan = R.FaultPlan.single("route", "exception", step=4, layer=2)
        x = torch.ones((1, 2))
        for _ in range(2):
            plan.apply("route", x, step=4)
            plan.apply("route", x, step=5)
            plan.apply("execute", x, step=4)
        with pytest.raises(R.InjectedFault):
            plan.apply("route", x, step=4)
        assert plan.triggered == [("route", "exception", 4, ())]

    def test_exception_and_straggler(self):
        plan = R.FaultPlan([R.FaultSpec("route", "exception", step=1),
                            R.FaultSpec("route", "straggler", step=2,
                                        delay_s=0.0)])
        x = torch.ones((1, 2))
        plan.apply("route", x, step=0)
        with pytest.raises(R.InjectedFault):
            plan.apply("route", x, step=1)
        assert plan.apply("route", x, step=2) is x
        assert [t[1] for t in plan.triggered] == ["exception", "straggler"]

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_plan_is_the_reference(self, seed):
        uids = list(range(20))
        got = R.FaultPlan.random(seed, uids, 0.4)
        want = RR.FaultPlan.random(seed, uids, 0.4)
        assert _specs_key(got.specs) == _specs_key(want.specs)
        assert 0 < len(got.specs) < len(uids)
        kw = dict(stages=("route", "sample"), kinds=("inf",), max_step=3)
        assert _specs_key(R.FaultPlan.random(seed, uids, 0.7, **kw).specs) \
            == _specs_key(RR.FaultPlan.random(seed, uids, 0.7, **kw).specs)


class TestPolicies:
    def test_retry_schedule(self):
        rp = R.RetryPolicy(max_retries=4, base_delay_s=0.1, multiplier=2.0,
                           max_delay_s=0.5)
        assert rp.schedule() == pytest.approx([0.1, 0.2, 0.4, 0.5])
        assert R.RetryPolicy(base_delay_s=0.0).schedule() == [0.0, 0.0]

    def test_ladder_order_and_threshold(self):
        lad = R.DegradationLadder(["pipeline_serial", "kv_wide", "mask_ref"],
                                  fail_threshold=2)
        rungs = [lad.note_failure() for _ in range(7)]
        assert rungs == [None, "kv_wide", None, "mask_ref", None,
                         "pipeline_serial", None]
        st = lad.state()
        assert st["applied"] == ["kv_wide", "mask_ref", "pipeline_serial"]
        assert st["pending"] == [] and st["failures"] == 7
        with pytest.raises(ValueError, match="unknown"):
            R.DegradationLadder(["nope"])
        with pytest.raises(ValueError, match="fail_threshold"):
            R.DegradationLadder([], fail_threshold=0)

    def test_ladder_for_serving_filters(self):
        lad = R.DegradationLadder.for_serving(
            kv_quant=None, attn_mask=None, pipeline_depth=0)
        assert lad.pending == []
        spec = AttnMaskSpec(local=True, impl="sparse")
        lad = R.DegradationLadder.for_serving(
            kv_quant="int8", attn_mask=spec, pipeline_depth=1)
        assert lad.pending == ["kv_wide", "mask_ref", "pipeline_serial"]
        lad = R.DegradationLadder.for_serving(
            kv_quant=None, attn_mask=dataclasses.replace(spec, impl="ref"),
            pipeline_depth=1)
        assert lad.pending == ["pipeline_serial"]

    def test_health_tracker(self):
        h = R.HealthTracker()
        for i in range(R.HealthTracker.MAX_EVENTS + 5):
            h.record("retry", attempt=i)
        h.record("shed", uid=3)
        snap = h.snapshot()
        assert snap["counters"] == {"retry": R.HealthTracker.MAX_EVENTS + 5,
                                    "shed": 1}
        assert len(snap["events"]) == R.HealthTracker.MAX_EVENTS
        assert snap["events"][0] == {"event": "retry", "attempt": 0}


# ------------------------------------------------------------ cache helpers --

def _from_ref(tree):
    if isinstance(tree, dict):
        return {k: _from_ref(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_from_ref(v) for v in tree)
    return to_tensor(jax.device_get(tree))


def _assert_tree_equal(got, want):
    """Leaf by leaf, exactly (NaN where the reference has NaN)."""
    g, w = _leaves(got), _leaves(_from_ref(want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@functools.lru_cache(maxsize=None)
def _reference_cache(kv_quant):
    """The reference's prefill cache of two prompts (numpy seed 3)."""
    rcfg, _, rparams, _, _ = _build()
    prompts = np.random.default_rng(3).integers(0, rcfg.vocab_size,
                                                (2, PROMPT))
    _, cache, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                             max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                             kv_quant=kv_quant)
    return cache


@pytest.mark.parametrize("kv_quant", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_dequantize_cache_is_the_reference(kv_quant):
    """``dequantize_cache`` of the reference's quantized prefill cache:
    every leaf ``torch.equal`` to the reference's result (no scale leaf
    left, k / v f32), other leaves passed through as the same tensor."""
    rcache = _reference_cache(kv_quant)
    cache = _from_ref(rcache)
    wide = R.dequantize_cache(cache, torch.float32)
    _assert_tree_equal(wide, RR.dequantize_cache(rcache, jnp.float32))
    for slot, new in zip(cache["slots"], wide["slots"]):
        assert set(new["attn"]) == {"k", "v"}
        if "moe" in slot:
            assert new["moe"] is slot["moe"]


@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_blank_cache_row_is_the_reference_in_place(kv_quant):
    """``model.blank_cache_row`` == the reference's on the same cache,
    written into the same storage, every other row untouched."""
    rcache = _reference_cache(kv_quant)
    cache = _from_ref(rcache)
    before = [x.clone() for x in _leaves(cache)]
    ptrs = [x.data_ptr() for x in _leaves(cache)]
    assert M.blank_cache_row(cache, 1) is cache
    _assert_tree_equal(cache, RM.blank_cache_row(rcache, 1))
    assert [x.data_ptr() for x in _leaves(cache)] == ptrs
    for x, b in zip(_leaves(cache), before):
        assert torch.equal(x[:, 0], b[:, 0])


@pytest.mark.parametrize("kind", ["nan", "inf"])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_corrupt_quant_scales_is_the_reference_in_place(kv_quant, kind):
    """``corrupt_quant_scales`` == the reference's (scales of a quantized
    cache, wide k / v otherwise), in place, row 0 untouched."""
    rcache = _reference_cache(kv_quant)
    cache = _from_ref(rcache)
    before = [x.clone() for x in _leaves(cache)]
    ptrs = [x.data_ptr() for x in _leaves(cache)]
    assert R.corrupt_quant_scales(cache, [1], kind) is cache
    _assert_tree_equal(cache, RR.corrupt_quant_scales(rcache, [1], kind))
    assert [x.data_ptr() for x in _leaves(cache)] == ptrs
    for x, b in zip(_leaves(cache), before):
        assert torch.equal(x[:, 0], b[:, 0])
    assert sum(not torch.equal(x, b) for x, b in
               zip(_leaves(cache), before)) == 2 * TINY_KW["n_repeats"]


# ------------------------------------------------------------ fault matrix --

# the reference's (tests/test_resilience.py): (stage, kind, selectors,
# kv_quant); uid 0 is resident from step 0
MATRIX = [
    ("prefill", "nan", dict(uid=1), None),
    ("prefill", "inf", dict(uid=0), None),
    ("prefill", "exception", dict(uid=1), None),
    ("attention", "inf", dict(uid=0, step=1), None),
    ("route", "nan", dict(uid=0, step=1), None),
    ("route", "exception", dict(step=2), None),
    ("route", "straggler", dict(step=1, delay_s=0.0), None),
    ("execute", "nan", dict(uid=1, step=1), None),
    ("execute", "exception", dict(step=0), None),
    ("sample", "nan", dict(uid=0, step=2), None),
    ("sample", "inf", dict(uid=1, step=0), None),
    ("quantize", "nan", dict(uid=0, step=1), "int8"),
    ("quantize", "inf", dict(uid=1, step=0), "int8"),
]
# (dispatch, depth, two_phase): two-phase fires every stage; fused has no
# attention / route / execute stage, as the reference's fused path
TWO_PHASE = [("bcsr", 0, True), ("bcsr", 1, True), ("gather", 0, True),
             ("gather", 1, True)]
FUSED = [("gather", 0, False), ("gather", 1, False), ("bcsr", 0, False),
         ("bcsr", 1, False)]
FUSED_STAGES = ("prefill", "sample", "quantize")


def _check_fault(mode, stage, kind, sel, kvq):
    dispatch, depth, two_phase = mode
    spec = R.FaultSpec(stage, kind, **sel)
    plan = R.FaultPlan([spec])
    sched, out = _run(dispatch=dispatch, depth=depth, two_phase=two_phase,
                      plan=plan, kv_quant=kvq)
    assert plan.triggered, "the fault never fired"
    failed = {r.uid for r in sched.failed}
    if kind in ("exception", "straggler") or stage == "prefill":
        assert not failed
    else:
        assert failed, "an activation poison must fail its request"
    _assert_survivors(out, _baseline(dispatch, depth, two_phase, kvq),
                      failed)
    _, rfailed, rtriggered = _reference(_specs_key([spec]), kvq)
    assert failed == rfailed
    assert plan.triggered == rtriggered
    assert sched.summary()["health"]["faults_triggered"] == plan.triggered
    return sched


@pytest.mark.parametrize("stage,kind,sel,kvq", MATRIX,
                         ids=[f"{s}-{k}" for s, k, _, _ in MATRIX])
@pytest.mark.parametrize("mode", TWO_PHASE,
                         ids=[f"{d}-d{p}" for d, p, _ in TWO_PHASE])
def test_fault_matrix_two_phase(mode, stage, kind, sel, kvq):
    """Two-phase bcsr and gather at depths 0 and 1: every stage x kind
    keeps survivors' tokens, fails the reference's uids and fires what the
    reference's gather run fires."""
    _check_fault(mode, stage, kind, sel, kvq)


FUSED_MATRIX = [m for m in MATRIX if m[0] in FUSED_STAGES]


@pytest.mark.parametrize("stage,kind,sel,kvq", FUSED_MATRIX,
                         ids=[f"{s}-{k}" for s, k, _, _ in FUSED_MATRIX])
@pytest.mark.parametrize("mode", FUSED,
                         ids=[f"fused-{d}-d{p}" for d, p, _ in FUSED])
def test_fault_matrix_fused(mode, stage, kind, sel, kvq):
    """Fused gather and bcsr: the prefill, sample and quantize stages (the
    quantize corruption written into the pool the step reads in place)."""
    _check_fault(mode, stage, kind, sel, kvq)


# the reference's CROSS: bcsr two-phase, gather fused, as its _run_sched
CROSS = [
    ("bcsr", 0, "execute", "inf", dict(uid=0, step=1), None),
    ("bcsr", 0, "route", "exception", dict(step=1), None),
    ("bcsr", 0, "quantize", "nan", dict(uid=0, step=0), "int8"),
    ("gather", 1, "sample", "nan", dict(uid=1, step=2), None),
    ("gather", 1, "prefill", "nan", dict(uid=0), None),
    ("gather", 0, "sample", "inf", dict(uid=0, step=1), None),
    ("gather", 0, "quantize", "inf", dict(uid=1, step=1), "int8"),
]


@pytest.mark.parametrize(
    "dispatch,depth,stage,kind,sel,kvq", CROSS,
    ids=[f"{d}-d{p}-{s}-{k}" for d, p, s, k, _, _ in CROSS])
def test_fault_matrix_cross(dispatch, depth, stage, kind, sel, kvq):
    _check_fault((dispatch, depth, dispatch == "bcsr"), stage, kind, sel,
                 kvq)


@pytest.mark.parametrize("kvq", [None, "int8"])
def test_fault_free_tokens_are_the_reference(kvq):
    """Fault-free, every mode's tokens == the reference's gather run's."""
    want = _reference((), kvq)[0]
    for mode in TWO_PHASE + FUSED:
        _assert_survivors(_baseline(*mode, kvq), want)


# ------------------------------------------------ retry from the same pool --

def _snapshots(sched, prompts, gen, steps):
    """Drive the trace; a copy of every pool leaf after each step in
    ``steps``.  Returns ({uid: tokens}, {step: leaves})."""
    for p in prompts:
        sched.submit(p, gen)
    snaps = {}
    while sched.has_work():
        sched.step()
        if sched.step_idx - 1 in steps:
            snaps[sched.step_idx - 1] = [x.clone()
                                         for x in _leaves(sched.cache)]
    return {r.uid: list(r.tokens) for r in sched.finished}, snaps


def _assert_pool_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("dispatch", ["bcsr", "gather"])
def test_execute_exception_at_layer1_restores_the_pool(dispatch, depth):
    """Two-phase, an ``execute`` exception at the second MoE layer of step
    1 (``layer=1``): the first try has written layer 0's occupancy.  The
    retry starts from the saved pool: tokens and every pool leaf after the
    step ``torch.equal`` to the fault-free run's; ``triggered`` == the
    reference's."""
    _, _, _, _, prompts = _build()
    steps = {1, 2}
    base, want = _snapshots(_sched(dispatch=dispatch, depth=depth),
                            prompts, GEN, steps)
    spec = R.FaultSpec("execute", "exception", step=1, layer=1)
    plan = R.FaultPlan([spec])
    sched = _sched(dispatch=dispatch, depth=depth, plan=plan)
    got, snaps = _snapshots(sched, prompts, GEN, steps)
    assert got == base and not sched.failed
    for s in steps:
        _assert_pool_equal(snaps[s], want[s])
    assert plan.triggered == _reference(_specs_key([spec]), None)[2]
    assert sched.health.counters["retry"] == 1
    assert sched.health.counters["decode_error"] == 1


def test_without_the_save_the_retry_diverges(monkeypatch):
    """The same fault with the save patched out: layer 0's occupancy is
    advanced twice, so the pool after the step differs -- what the save
    is for."""
    _, _, _, _, prompts = _build()
    _, want = _snapshots(_sched(), prompts, GEN, {1})
    monkeypatch.setattr(ServeScheduler, "_keep_step_state",
                        lambda self, bucket, retry: None)
    plan = R.FaultPlan.single("execute", "exception", step=1, layer=1)
    _, snaps = _snapshots(_sched(plan=plan), prompts, GEN, {1})
    assert not all(torch.equal(x, y) for x, y in zip(snaps[1], want[1]))


@pytest.mark.parametrize("save", [True, False])
def test_rwkv_fused_sample_exception_restores_the_pool(monkeypatch, save):
    """rwkv6-7b SMOKE, fused: a ``sample`` exception after step 1's step
    has stepped every layer's WKV state and shifts.  With the save, tokens
    and every pool leaf after steps 1 and 2 ``torch.equal`` to the
    fault-free run's; without it, the state differs."""
    _, _, _, _, prompts = _build("rwkv")
    steps = {1, 2}
    base, want = _snapshots(_sched("rwkv", two_phase=False), prompts, GEN,
                            steps)
    if not save:
        monkeypatch.setattr(ServeScheduler, "_keep_step_state",
                            lambda self, bucket, retry: None)
    plan = R.FaultPlan.single("sample", "exception", step=1)
    sched = _sched("rwkv", two_phase=False, plan=plan)
    got, snaps = _snapshots(sched, prompts, GEN, steps)
    assert plan.triggered == [("sample", "exception", 1, ())]
    if save:
        assert got == base
        for s in steps:
            _assert_pool_equal(snaps[s], want[s])
    else:
        assert not all(torch.equal(x, y) for x, y in zip(snaps[1], want[1]))


def test_no_save_without_retries():
    """``RetryPolicy(max_retries=0)``: no buffer is made, and a decode
    exception raises at once."""
    sched, out = _run(retry=R.RetryPolicy(max_retries=0))
    assert sched._step_saved is None
    _assert_survivors(out, _baseline("bcsr", 0, True, None))
    plan = R.FaultPlan.single("sample", "exception", step=0)
    sched = _sched(plan=plan, retry=R.RetryPolicy(max_retries=0))
    for p in _build()[4]:
        sched.submit(p, GEN)
    with pytest.raises(RuntimeError, match="after 0 retries"):
        sched.run()


@pytest.mark.parametrize("stage", ["prefill", "sample"])
def test_retry_keeps_the_generators_at_temperature(stage):
    """At temperature 0.7 a retried admission (poisoned first-token logits:
    the request's generator put back) or a retried step (the sample hook
    fires before any draw) samples the fault-free tokens."""
    base = _run(two_phase=False, dispatch="gather", temperature=0.7)[1]
    kind, sel = ("nan", dict(uid=0)) if stage == "prefill" else \
        ("exception", dict(step=1))
    plan = R.FaultPlan.single(stage, kind, **sel)
    sched, out = _run(two_phase=False, dispatch="gather", temperature=0.7,
                      plan=plan)
    assert plan.triggered and not sched.failed
    _assert_survivors(out, base)


# ---------------------------------------------------------------- ServeLoop --

def _loop(plan=None, **kw):
    _, cfg, _, params, _ = _build()
    return ServeLoop(params, cfg, max_seq=MAX_SEQ, fault_plan=plan,
                     device="cpu", **kw)


LOOP_PROMPTS = np.random.default_rng(1).integers(0, 64, (2, PROMPT))


@pytest.mark.parametrize("mode,stage", [
    (dict(dispatch="bcsr", pipeline_depth=1), "execute"),
    (dict(dispatch="gather", pipeline_depth=0), "sample"),
    (dict(dispatch="gather", pipeline_depth=1, two_phase=False), "sample")])
def test_loop_poison_isolated_per_row(mode, stage):
    """A poisoned row is reported in ``health_rows`` / ``rows_finite`` (one
    fetch, with the tokens) while the other row's tokens stay."""
    base = _loop(**mode)
    want = base.run(LOOP_PROMPTS, GEN)
    assert base.health_rows.tolist() == [True, True]
    plan = R.FaultPlan.single(stage, "nan", row=1, step=2)
    loop = _loop(plan, **mode)
    out = loop.run(LOOP_PROMPTS, GEN)
    assert loop.health_rows.tolist() == [True, False]
    np.testing.assert_array_equal(out[0], want[0])
    s = loop.summary()["health"]
    assert s["rows_finite"] == [True, False]
    assert s["counters"] == {"rows_poisoned": 1}
    assert s["faults_triggered"] == [(stage, "nan", 2, (1,))]


def test_loop_exception_aborts_pipeline_and_stays_usable():
    want = _loop(dispatch="bcsr", pipeline_depth=1).run(LOOP_PROMPTS, GEN)
    plan = R.FaultPlan.single("route", "exception", step=1)
    loop = _loop(plan, dispatch="bcsr", pipeline_depth=1)
    with pytest.raises(R.InjectedFault):
        loop.run(LOOP_PROMPTS, GEN)
    assert len(loop._pipe) == 0
    np.testing.assert_array_equal(loop.run(LOOP_PROMPTS, GEN), want)


def test_loop_quantize_poisons_the_static_cache():
    """Fused, the quantize hook corrupts the static cache the step reads in
    place: the row's logits go non-finite from that step on."""
    plan = R.FaultPlan.single("quantize", "nan", row=0, step=1)
    loop = _loop(plan, dispatch="gather", kv_quant="int8")
    loop.run(LOOP_PROMPTS, GEN)
    assert loop.health_rows.tolist() == [False, True]
    assert loop.fused_step.cache is loop.cache


# ------------------------------------------------------------------- retry --

class TestRetryPolicyIntegration:
    def test_prefill_retry_to_success(self):
        plan = R.FaultPlan.single("prefill", "nan", uid=0)
        sched, out = _run(plan=plan)
        assert not sched.failed
        assert next(r for r in sched.finished if r.uid == 0).retries == 1
        assert sched.summary()["requests"]["retries"] == 1
        _assert_survivors(out, _baseline("bcsr", 0, True, None))

    def test_prefill_retry_exhaustion(self):
        plan = R.FaultPlan.single("prefill", "nan", uid=0, times=99)
        sched, out = _run(plan=plan, retry=R.RetryPolicy(max_retries=2))
        assert {r.uid for r in sched.failed} == {0}
        req = sched.failed[0]
        assert req.state == "failed" and req.retries == 2
        assert req.fail_reason == "prefill_poisoned" and req.slot is None
        assert sched.summary()["health"]["failed"] == [
            {"uid": 0, "reason": "prefill_poisoned"}]
        _assert_survivors(out, _baseline("bcsr", 0, True, None), {0})

    def test_prefill_exception_exhaustion(self):
        """An exception fault fires whatever its uid selector (a host
        failure has no row, as in the reference): with retries spent,
        every admission fails, each after one retry."""
        plan = R.FaultPlan.single("prefill", "exception", uid=1, times=99)
        sched, out = _run(plan=plan, retry=R.RetryPolicy(max_retries=1))
        assert out == {} and not sched.has_work()
        assert [(r.uid, r.fail_reason, r.retries) for r in sched.failed] == [
            (uid, "prefill_error:InjectedFault", 1) for uid in range(N_REQ)]
        assert len(plan.triggered) == 2 * N_REQ

    def test_backoff_delays_follow_schedule(self):
        plan = R.FaultPlan.single("prefill", "nan", uid=0, times=99)
        sched = _sched(plan=plan, depth=1, retry=R.RetryPolicy(
            max_retries=3, base_delay_s=0.01, multiplier=2.0,
            max_delay_s=0.03))
        slept = []
        sched._sleep = slept.append
        for p in _build()[4]:
            sched.submit(p, GEN)
        sched.run()
        assert slept == pytest.approx([0.01, 0.02, 0.03])

    def test_decode_retry_exhaustion_raises(self):
        plan = R.FaultPlan.single("route", "exception", step=1, times=99)
        sched = _sched(plan=plan, depth=1, retry=R.RetryPolicy(max_retries=1))
        for p in _build()[4]:
            sched.submit(p, GEN)
        with pytest.raises(RuntimeError, match="failed after 1 retries"):
            sched.run()
        assert len(sched._pipe) == 0


# ------------------------------------------------------- deadlines, queue --

class TestDeadlinesAndShedding:
    def _sched(self, **kw):
        return _sched(dispatch="gather", two_phase=False, max_slots=1, **kw)

    def test_deadlines_fake_clock(self):
        prompts = _build()[4]
        t = [0.0]
        sched = self._sched(clock=lambda: t[0])
        sched.submit(prompts[0], GEN)
        r1 = sched.submit(prompts[1], GEN, ttft_deadline_s=0.5)
        r2 = sched.submit(prompts[2], GEN, deadline_s=0.3)
        t[0] = 1.0
        sched.step()
        assert {r.uid for r in sched.shed} == {r1.uid, r2.uid}
        assert r1.fail_reason == "ttft_deadline"
        assert r2.fail_reason == "deadline"
        sched.run()
        assert len(sched.finished) == 1
        s = sched.summary()
        assert s["requests"]["shed"] == 2
        assert {e["reason"] for e in s["health"]["shed"]} == {
            "ttft_deadline", "deadline"}

    def test_resident_total_deadline_fails(self):
        t = [0.0]
        sched = self._sched(clock=lambda: t[0])
        req = sched.submit(_build()[4][0], MAX_SEQ - PROMPT, deadline_s=0.5)
        sched.step()
        assert req.state == "active"
        t[0] = 1.0
        sched.step()
        assert req.state == "failed" and req.fail_reason == "deadline"
        assert not sched.has_work()

    def test_first_token_latency_on_the_clock(self):
        t = [5.0]
        sched = self._sched(clock=lambda: t[0])
        req = sched.submit(_build()[4][0], 2)
        t[0] = 7.5
        sched.run()
        assert req.first_token_s == 2.5

    def test_bounded_queue_reject(self):
        prompts = _build()[4]
        sched = self._sched(max_queue=1, shed_policy="reject")
        sched.submit(prompts[0], 2)
        with pytest.raises(R.ShedError, match="queue full"):
            sched.submit(prompts[1], 2)
        assert sched.health.counters["shed"] == 1

    def test_bounded_queue_drop_oldest(self):
        prompts = _build()[4]
        sched = self._sched(max_queue=1, shed_policy="drop_oldest")
        a = sched.submit(prompts[0], 2)
        b = sched.submit(prompts[1], 2)
        assert a.state == "shed" and a.fail_reason == "queue_full_drop_oldest"
        assert list(sched.queue) == [b]

    def test_shed_policy_refused(self):
        with pytest.raises(ValueError, match="shed_policy"):
            self._sched(shed_policy="lifo")

    def test_empty_run_summary_zeroes(self):
        t = [0.0]
        sched = self._sched(clock=lambda: t[0])
        sched.submit(_build()[4][0], GEN, deadline_s=0.1)
        t[0] = 1.0
        sched.step()
        s = sched.summary()
        assert s["token_latency_ms"]["n"] == 0
        assert s["first_token_ms"] == {"p50": 0.0, "p99": 0.0, "mean": 0.0,
                                       "n": 0}
        assert s["requests"]["shed"] == 1 and "decode" not in s


# ------------------------------------------------------------------ ladder --

def test_ladder_integration_walks_rungs():
    """``fail_threshold=1``, two poisoned rows: ``kv_wide`` (the live pool
    now wide f32, no scale leaf) then ``pipeline_serial`` (depth 0); the
    request left finishes."""
    plan = R.FaultPlan([R.FaultSpec("execute", "nan", uid=0, step=0),
                        R.FaultSpec("execute", "nan", uid=1, step=1)])
    sched, _ = _run(depth=1, kv_quant="int8", plan=plan, fail_threshold=1)
    assert sched.ladder.state()["applied"] == ["kv_wide", "pipeline_serial"]
    assert sched.kv_quant is None and sched.pipeline_depth == 0
    assert sched._pipe.depth == 0
    for slot in sched.cache["slots"]:
        assert set(slot["attn"]) == {"k", "v"}
        assert slot["attn"]["k"].dtype == torch.float32
    assert [r.uid for r in sched.finished] == [2]
    degr = [e["rung"] for e in sched.summary()["health"]["events"]
            if e["event"] == "degrade"]
    assert degr == ["kv_wide", "pipeline_serial"]


def test_mask_ref_rung_rewrites_spec():
    spec = AttnMaskSpec(local=True, impl="sparse")
    loop = _loop(dispatch="gather", attn_mask=spec)
    assert loop.ladder.pending == ["mask_ref"]
    loop._apply_rung("mask_ref")
    assert loop.attn_mask == dataclasses.replace(spec, impl="ref")
    assert loop.health.counters["degrade"] == 1


def test_fused_kv_wide_rebuilds_the_steps_on_an_f32_pool():
    """Fused int8 scheduler, ``fail_threshold=1``, one poisoned row: after
    ``kv_wide`` every bucket's step is made anew over the wide f32 pool's
    own storage; the other requests finish."""
    plan = R.FaultPlan.single("sample", "nan", uid=0, step=1)
    sched = _sched(dispatch="gather", two_phase=False, kv_quant="int8",
                   plan=plan, fail_threshold=1)
    for p in _build()[4]:
        sched.submit(p, GEN)
    old = {}
    while sched.has_work():
        if not old:
            old = dict(sched._fused)
        sched.step()
    assert [r.uid for r in sched.failed] == [0]
    assert sorted(r.uid for r in sched.finished) == [1, 2]
    assert sched.ladder.state()["applied"] == ["kv_wide"]
    assert sched.kv_quant is None and sched._fused
    for b, step in sched._fused.items():
        assert step is not old.get(b)
        for leaf, pool in zip(_leaves(step.cache), _leaves(sched.cache)):
            assert leaf.data_ptr() == pool.data_ptr()
        assert step.cache["slots"][0]["attn"]["k"].dtype == torch.float32


# -------------------------------------------------------------- host reads --

def _count_host_reads():
    """Every way a tensor reaches the host, counted by name, except inside
    the plain version of K2 (``spmm_bcsr_ref``), which stands on the CPU
    for a kernel that reads nothing on the host.  Returns (patch, restore,
    counts)."""
    names = ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
             "__float__", "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    plain = spmm_ref.spmm_bcsr_ref.__code__
    counts = []

    def counter(name):
        def read(self, *a, **kw):
            f = sys._getframe(1)
            while f is not None and f.f_code is not plain:
                f = f.f_back
            if f is None:
                counts.append(name)
            return saved[name](self, *a, **kw)
        return read

    def patch():
        for n in names:
            setattr(torch.Tensor, n, counter(n))

    def restore():
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
    return patch, restore, counts


def _step_reads(plan, **kw):
    sched = _sched(plan=plan, **kw)
    for p in _build()[4][:2]:
        sched.submit(p, 8)
    sched.step()                          # admits both, makes bucket 2
    patch, restore, counts = _count_host_reads()
    patch()
    try:
        emitted = sched.decode_step()
    finally:
        restore()
    assert len(emitted) == 2
    return counts


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
def test_fused_step_reads_the_host_once_with_a_plan(dispatch, depth):
    """With a plan attached (armed for a uid never served), a fused step's
    tokens and health bits come back in its one fetch."""
    plan = R.FaultPlan.single("sample", "nan", uid=99)
    counts = _step_reads(plan, dispatch=dispatch, depth=depth,
                         two_phase=False)
    assert counts == ["cpu", "numpy"]


@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
def test_two_phase_step_reads_as_without_a_plan(dispatch):
    """A depth-1 two-phase step makes the host reads it makes without a
    plan (the slot fetches and the one token fetch)."""
    plan = R.FaultPlan.single("execute", "nan", uid=99)
    with_plan = _step_reads(plan, dispatch=dispatch, depth=1)
    assert with_plan == _step_reads(None, dispatch=dispatch, depth=1)
    assert with_plan[-2:] == ["cpu", "numpy"]
