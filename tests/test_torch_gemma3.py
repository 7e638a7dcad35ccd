"""Port vs reference: gemma3-12b serving on the CPU.

gemma3-12b's stack is five ``attn_local`` layers (a sliding window of
``local_window``, ring-buffer decode caches) to one ``attn_global``, with
``qk_norm``.  Held here on its SMOKE config (f32 policy, window 16, head
dim 16; weights from the reference's ``init_params`` through
``interop.params_from_jax``, prompts from numpy seeds):

* the configs, field for field;
* ``model.prefill`` logits and caches at prompts below, equal to and past
  the window (the rings compared slot by slot), then decode steps across
  the window at an int and at a ``(B,)`` position (rows crossing it at
  different steps), and at ``max_seq`` below the window (local caches
  that are no rings, decoded under the window): logits within 1e-4 and f32
  caches within 1e-5 of their largest |value|;
* masked prefill (``AttnMaskSpec`` sliding / local_global, the port's plain
  K4s / K4m against the reference's masked prefill in interpret mode):
  logits within 1e-4, sparse == dense as ``torch.equal``;
* ``kv_quant``: the rings stay wide (``torch.equal`` to the wide
  prefill's), the global caches quantized as the reference quantizes
  (scales within 1e-5 relative, values within one step), ``init_cache``'s
  leaves as the reference's;
* greedy ``ServeScheduler`` tokens (fused and two-phase) equal to the
  reference's gather scheduler and to each request alone through
  ``ServeLoop``; fused == layered ``ServeLoop`` (tokens, first decode
  logits ``torch.equal``, greedy and at 0.7); a retried step's pool
  ``torch.equal`` to the fault-free run's;
* ``cache_capacity`` / ``check_cache_fits`` with rings, ``blank_cache_row``
  on a ring row, the CLI.

Tokens are compared exactly, never within a tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.core.masks import AttnMaskSpec as RAttnMaskSpec
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM

from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.runtime import resilience as R

torch.set_num_threads(2)
ARCH = "gemma3-12b"
B = 2
MAX_SEQ = 40                     # past the SMOKE window of 16
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _build():
    rcfg = dataclasses.replace(r_get_smoke(ARCH), policy="f32")
    cfg = dataclasses.replace(configs.get_smoke(ARCH), policy="f32")
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    return rcfg, cfg, rparams, params


def _prompts(S, seed=None, rows=B):
    cfg = _build()[1]
    return np.random.default_rng(S if seed is None else seed).integers(
        0, cfg.vocab_size, (rows, S)).astype(np.int32)


def _close(got, want, rel, what):
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


def _close_caches(cache, rcache, rel, what):
    """Every attention leaf of the port's cache against the reference's,
    slot by slot (a ring's slot j against the reference's slot j)."""
    for i, (slot, rslot) in enumerate(zip(cache["slots"], rcache["slots"])):
        for name, leaf in slot["attn"].items():
            _close(leaf, rslot["attn"][name], rel, f"{what} slot {i} {name}")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_reference(which):
    """``get_config`` / ``get_smoke`` field for field the reference's."""
    get = {"CONFIG": (configs.get_config, r_get_config),
           "SMOKE": (configs.get_smoke, r_get_smoke)}[which]
    assert dataclasses.asdict(get[0](ARCH)) == dataclasses.asdict(get[1](ARCH))
    assert ARCH in configs.ARCH_NAMES
    cfg = configs.get_config(ARCH)
    assert [M._window_for(k, cfg) for k in cfg.block_unit] == \
        [1024] * 5 + [None]


def test_params_from_jax_keeps_qk_norm_f32():
    """The reference's tree converts leaf for leaf: matmul weights in the
    compute dtype, every norm scale (``q_norm`` / ``k_norm`` too) f32, the
    same tree as ``init_params``."""
    rcfg = r_get_smoke(ARCH)
    cfg = configs.get_smoke(ARCH)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    for slot in params["blocks"]:
        attn = slot["attn"]
        assert attn["q_norm"]["scale"].dtype == torch.float32
        assert attn["k_norm"]["scale"].dtype == torch.float32
        assert attn["wq"].dtype == torch.bfloat16
    mine = M.init_params(cfg, device="cpu")
    shapes = lambda t: [(x.shape, x.dtype) for x in _leaves(t)]  # noqa: E731
    assert shapes(mine) == shapes(params)


# --------------------------------------------------------------- prefill --

@pytest.mark.parametrize("S", [8, 16, 20])
def test_prefill_logits_and_rings_match_reference(S):
    """``M.prefill`` against the reference's at S below, equal to and past
    the window: logits within 1e-4, f32 caches within 1e-5, slot by slot
    (local caches of ``local_window`` slots, global of ``MAX_SEQ``); past
    the window, ring slot j holds the last window's position p with p %
    window == j."""
    rcfg, cfg, rparams, params = _build()
    prompts = _prompts(S)
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ, cache_dtype=jnp.float32)
    logits, cache, pos = M.prefill(params, torch.from_numpy(prompts).long(),
                                   cfg, max_seq=MAX_SEQ,
                                   cache_dtype=torch.float32)
    assert pos == int(rpos) == S
    _close(logits, rl, LOGIT_TOL, f"prefill S={S}")
    _close_caches(cache, rc, CACHE_TOL, f"prefill S={S}")
    W = cfg.local_window
    lengths = [s["attn"]["k"].shape[3] for s in cache["slots"]]
    assert lengths == [W, W, MAX_SEQ]
    if S >= W:
        # layer 0's keys in position order, from a window past the prompt
        # (its keys do not depend on the window)
        wide = dataclasses.replace(cfg, local_window=MAX_SEQ)
        _, full, _ = M.prefill(params, torch.from_numpy(prompts).long(),
                               wide, max_seq=MAX_SEQ,
                               cache_dtype=torch.float32)
        k_ring = cache["slots"][0]["attn"]["k"][0]
        k_full = full["slots"][0]["attn"]["k"][0]
        for j in range(W):
            p = S - W + (j - (S - W)) % W
            assert p % W == j
            assert torch.equal(k_ring[:, :, j], k_full[:, :, p]), (j, p)


# ---------------------------------------------------------------- decode --

def _stacked_prefill(lengths, max_seq):
    """Each row's prompt prefilled alone (B = 1) on both sides, the rows'
    caches concatenated: rows at their own positions, as a scheduler holds
    them."""
    rcfg, cfg, rparams, params = _build()
    rows, rrows, firsts = [], [], []
    for i, S in enumerate(lengths):
        pr = _prompts(S, seed=100 + i, rows=1)
        rl, rc, _ = RM.prefill(rparams, jnp.asarray(pr), rcfg,
                               max_seq=max_seq, cache_dtype=jnp.float32)
        _, c, _ = M.prefill(params, torch.from_numpy(pr).long(), cfg,
                            max_seq=max_seq, cache_dtype=torch.float32)
        rows.append(c)
        rrows.append(rc)
        firsts.append(np.argmax(np.asarray(rl)[:, -1, :cfg.vocab_size], -1))
    cache = {"slots": tuple(
        {"attn": {n: torch.cat([r["slots"][s]["attn"][n] for r in rows], 1)
                  for n in ("k", "v")}}
        for s in range(len(cfg.block_unit)))}
    rcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, 1), *rrows)
    tok = np.stack(firsts).astype(np.int32).reshape(-1, 1)
    return cache, rcache, tok


@pytest.mark.parametrize("kind,lengths,max_seq", [
    ("int", (12, 12), MAX_SEQ), ("vector", (10, 14), MAX_SEQ),
    ("vector", (16, 9), MAX_SEQ), ("int", (6, 6), 12)])
def test_decode_across_the_window_matches_reference(kind, lengths, max_seq):
    """Decode steps that cross the window (rows at different steps when
    their positions differ), at an int and at a ``(B,)`` position, against
    the reference's ``decode_step`` at the same positions: logits within
    1e-4, f32 caches within 1e-5 after the last step.  At ``max_seq`` 12 <
    16 the local caches are no rings and decode under the window (the
    reference's ``Lc == window`` rule).  The vector path equals the int
    path at equal positions, ``torch.equal``."""
    rcfg, cfg, rparams, params = _build()
    cache, rcache, tok = _stacked_prefill(lengths, max_seq)
    pos = np.array(lengths)
    steps = max_seq - max(lengths) if max_seq < MAX_SEQ else 9
    for _ in range(steps):
        p = int(pos[0]) if kind == "int" else pos
        rlg, rcache = RM.decode_step(rparams, rcfg, rcache,
                                     jnp.asarray(p, jnp.int32),
                                     jnp.asarray(tok), dtype=jnp.float32)
        lg, cache = M.decode_step_layered(params, cfg, cache, p,
                                          torch.from_numpy(tok).long())
        _close(lg, rlg, LOGIT_TOL, f"decode at {pos}")
        tok = np.argmax(np.asarray(rlg)[:, -1, :cfg.vocab_size],
                        -1)[:, None].astype(np.int32)
        pos = pos + 1
    _close_caches(cache, rcache, CACHE_TOL, f"decode to {pos}")
    if kind == "int":
        c_int, _, tok0 = _stacked_prefill(lengths, max_seq)
        c_vec = {"slots": tuple({"attn": {n: t.clone() for n, t in
                                          s["attn"].items()}}
                                for s in c_int["slots"])}
        t = torch.from_numpy(tok0).long()
        a, _ = M.decode_step_layered(params, cfg, c_int, lengths[0], t)
        b, _ = M.decode_step(params, cfg, c_vec,
                             torch.tensor(list(lengths)), t)
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in
                   zip(_leaves(c_int), _leaves(c_vec)))


def test_ring_decode_writes_slot_pos_mod_window():
    """A decode step at position p writes slot p % window of a ring and
    nothing else of it; a global cache at position p."""
    _, cfg, _, params = _build()
    W = cfg.local_window
    cache, _, tok = _stacked_prefill((W + 3, W + 3), MAX_SEQ)
    before = [{n: t.clone() for n, t in s["attn"].items()}
              for s in cache["slots"]]
    M.decode_step_layered(params, cfg, cache, W + 3,
                          torch.from_numpy(tok).long())
    for slot, was, kind in zip(cache["slots"], before, cfg.block_unit):
        at = 3 if kind == "attn_local" else W + 3
        for n in ("k", "v"):
            changed = (slot["attn"][n] != was[n]).any(-1).flatten(0, 2)
            assert changed.any(0).nonzero().flatten().tolist() == [at], \
                (kind, n)


# ---------------------------------------------------------------- masked --

@pytest.mark.parametrize("pattern", [None, "local_global"])
def test_masked_prefill_matches_reference(pattern):
    """``attn_mask=`` prefill past the window (local layers through the
    sliding-window mask; global layers through ``local_global`` when set):
    the port's plain K4s against the reference's masked prefill (its
    kernels in interpret mode), logits within 1e-4 and f32 caches within
    1e-5; the port's K4m (``impl="dense"``) ``torch.equal`` to K4s."""
    rcfg, cfg, rparams, params = _build()
    prompts = _prompts(24, seed=7)
    rl, rc, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                           max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                           attn_mask=RAttnMaskSpec(local=True,
                                                   pattern=pattern,
                                                   window=8))
    toks = torch.from_numpy(prompts).long()
    out = {impl: M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                           cache_dtype=torch.float32,
                           attn_mask=AttnMaskSpec(local=True, pattern=pattern,
                                                  window=8, impl=impl))
           for impl in ("sparse", "dense")}
    _close(out["sparse"][0], rl, LOGIT_TOL, f"masked prefill {pattern}")
    _close_caches(out["sparse"][1], rc, CACHE_TOL, f"masked {pattern}")
    assert torch.equal(out["sparse"][0], out["dense"][0])
    unmasked, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    if pattern is None:   # the sliding mask is the local layers' own window
        _close(out["sparse"][0], unmasked, LOGIT_TOL, "sliding vs unmasked")


def test_masked_serving_sparse_equals_dense():
    """``ServeLoop(attn_mask=)``: sparse and dense give the same tokens,
    fused and layered, with no oracle fallback."""
    _, cfg, _, params = _build()
    prompts = _prompts(20, seed=3)
    got = {}
    for impl in ("sparse", "dense"):
        for two_phase in (False, True):
            loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                             two_phase=two_phase,
                             attn_mask=AttnMaskSpec(local=True, impl=impl))
            got[impl, two_phase] = loop.run(prompts, 8)
            assert loop.summary()["timing"]["attention_ref_fallbacks"] == 0
    first = got["sparse", False]
    assert all(np.array_equal(first, t) for t in got.values())


# -------------------------------------------------------------- kv_quant --

def test_kv_quant_rings_wide_and_global_quantized():
    """``prefill(kv_quant="int8")``: the local rings stay wide and
    ``torch.equal`` to the wide prefill's, the logits ``torch.equal`` to
    wide, the global caches near the reference's quantized prefill
    (scales within 1e-5 relative, values within one step); and
    ``init_cache(kv_quant=)``'s leaves are the reference's."""
    rcfg, cfg, rparams, params = _build()
    prompts = _prompts(20, seed=5)
    toks = torch.from_numpy(prompts).long()
    wl, wide, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                            cache_dtype=torch.float32)
    ql, quant, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                             cache_dtype=torch.float32, kv_quant="int8")
    assert torch.equal(wl, ql)
    _, rq, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                          max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                          kv_quant="int8")
    for kind, slot, wslot, rslot in zip(cfg.block_unit, quant["slots"],
                                        wide["slots"], rq["slots"]):
        if kind == "attn_local":
            assert set(slot["attn"]) == set(rslot["attn"]) == {"k", "v"}
            assert all(torch.equal(slot["attn"][n], wslot["attn"][n])
                       for n in ("k", "v"))
            continue
        assert slot["attn"]["k"].dtype == torch.int8
        for n in ("k", "v"):
            rs = np.asarray(rslot["attn"][n + "_scale"], np.float64)
            s = slot["attn"][n + "_scale"].numpy().astype(np.float64)
            assert np.abs(s - rs).max() <= 1e-5 * rs.max()
            rd = np.asarray(rslot["attn"][n], np.float64) * rs[..., None]
            d = slot["attn"][n].numpy().astype(np.float64) * s[..., None]
            assert (np.abs(d - rd) <= rs[..., None] * (1 + 1e-5)).all()
    rinit = RM.init_cache(rcfg, 3, MAX_SEQ, kv_quant="int8")
    init = M.init_cache(cfg, 3, MAX_SEQ, device="cpu", kv_quant="int8")
    for slot, rslot in zip(init["slots"], rinit["slots"]):
        assert sorted(slot["attn"]) == sorted(rslot["attn"])
        for n, leaf in slot["attn"].items():
            want = np.asarray(rslot["attn"][n])
            assert tuple(leaf.shape) == want.shape
            assert np.array_equal(leaf.float().numpy(), want.astype(
                np.float32))


def test_kv_quant_serving_tokens_fused_equals_layered():
    """int8 KV serving: fused == layered tokens, the scheduler's rows ==
    alone under the same ``kv_quant``."""
    _, cfg, _, params = _build()
    prompts = _prompts(18, seed=9)
    got = [ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     two_phase=tp, kv_quant="int8").run(prompts, 10)
           for tp in (False, True)]
    assert np.array_equal(*got)
    reqs = _trace()
    toks = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                 device="cpu", kv_quant="int8"), reqs)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     kv_quant="int8")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], toks[uid]), uid


# ------------------------------------------------------------ scheduling --

def _trace():
    """Prompts of 8-15 tokens, budgets 6-11: rows cross the window of 16
    at different steps."""
    cfg = _build()[1]
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(8, 16))
                          ).astype(np.int32), int(rng.integers(6, 12)))
            for _ in range(4)]


def _drive(sched, reqs):
    """Three requests at step 0, the last after step 2; {uid: tokens}."""
    for prompt, gen in reqs[:3]:
        sched.submit(prompt, gen)
    late = False
    while sched.has_work():
        sched.step()
        if sched.step_idx == 2 and not late:
            sched.submit(*reqs[3])
            late = True
    return sched.run()


@functools.lru_cache(maxsize=None)
def _reference_tokens():
    rcfg, _, rparams, _ = _build()
    return _drive(RServeScheduler(rparams, rcfg, max_seq=32, max_slots=2,
                                  dispatch="gather"), _trace())


@pytest.mark.parametrize("two_phase", [False, True])
def test_scheduler_matches_reference_and_alone(two_phase):
    """Greedy ``ServeScheduler`` tokens (fused: one decode step a bucket
    over the pool's rows; two-phase: layered) == the reference's gather
    scheduler's, per request, and == each request alone through
    ``ServeLoop``."""
    _, cfg, _, params = _build()
    reqs = _trace()
    got = _drive(ServeScheduler(params, cfg, max_seq=32, max_slots=2,
                                device="cpu", two_phase=two_phase), reqs)
    want = _reference_tokens()
    assert sorted(got) == sorted(want)
    for uid in want:
        assert np.array_equal(got[uid], want[uid]), uid
    loop = ServeLoop(params, cfg, max_seq=32, device="cpu")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], got[uid]), uid


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_fused_equals_layered(temperature):
    """``ServeLoop`` fused (``model.decode_step`` on its static buffers)
    and layered give the same tokens, and at temperature 0 the same first
    decode step logits, ``torch.equal``; prompts past the window."""
    _, cfg, _, params = _build()
    prompts = _prompts(18, seed=11)
    out = {}
    for two_phase in (False, True):
        loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                         two_phase=two_phase, temperature=temperature)
        seen = []

        def keep(last, _s=loop._sample):
            seen.append(last.clone())
            return _s(last)

        loop._sample = keep
        out[two_phase] = (loop.run(prompts, 10), seen[1])
    assert np.array_equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


def test_retried_step_leaves_the_pool_as_the_fault_free_run():
    """A ``sample`` exception after a fused step, retried from the saved
    step state: every request and every pool leaf (rings included)
    ``torch.equal`` to the fault-free run's; a failed row is blanked to
    zeros, ring leaves too."""
    _, cfg, _, params = _build()
    reqs = _trace()

    def run(**kw):
        s = ServeScheduler(params, cfg, max_seq=32, max_slots=2,
                           device="cpu", **kw)
        return s, _drive(s, reqs)

    clean, want = run()
    plan = R.FaultPlan.single("sample", "exception", step=4)
    faulted, got = run(fault_plan=plan)
    assert plan.triggered and faulted.health.counters["retry"] == 1
    assert all(np.array_equal(got[u], want[u]) for u in want)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(clean.cache),
                                                  _leaves(faulted.cache)))
    M.blank_cache_row(clean.cache, 1)
    for leaf in _leaves(clean.cache):
        assert not leaf[:, 1].any()


def test_kv_wide_rung_widens_the_global_caches_and_keeps_the_rings():
    """Fused int8-KV scheduler, ``fail_threshold=1``, a poisoned row: the
    ``kv_wide`` rung dequantizes the global caches to f32 without scales
    and leaves the rings (wide already) as they are; every later step is
    made anew over the pool; the other requests finish."""
    _, cfg, _, params = _build()
    plan = R.FaultPlan.single("sample", "nan", uid=0, step=1)
    sched = ServeScheduler(params, cfg, max_seq=32, max_slots=2,
                           device="cpu", kv_quant="int8", fault_plan=plan,
                           fail_threshold=1)
    reqs = _trace()
    for p, g in reqs:
        sched.submit(p, g)
    while sched.has_work():
        sched.step()
    assert [r.uid for r in sched.failed] == [0]
    assert sorted(r.uid for r in sched.finished) == [1, 2, 3]
    assert sched.ladder.state()["applied"] == ["kv_wide"]
    for kind, slot in zip(cfg.block_unit, sched.cache["slots"]):
        assert set(slot["attn"]) == {"k", "v"}
        want = torch.bfloat16 if kind == "attn_local" else torch.float32
        assert slot["attn"]["k"].dtype == want, kind
    for step in sched._fused.values():
        for leaf, pool in zip(_leaves(step.cache), _leaves(sched.cache)):
            assert leaf.data_ptr() == pool.data_ptr()


# --------------------------------------------------------------- helpers --

def test_cache_capacity_leaves_rings_out():
    """Rings wrap: the local caches of exactly the window are left out of
    the overflow bound; local caches shorter than the window (``max_seq``
    below it) are no rings and count, and so does a global cache of the
    window's length."""
    cfg = configs.get_smoke(ARCH)
    W = cfg.local_window
    cache = M.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    assert M.cache_capacity(cache, cfg) == MAX_SEQ
    M.check_cache_fits(cache, MAX_SEQ - 1, cfg)
    with pytest.raises(ValueError):
        M.check_cache_fits(cache, MAX_SEQ, cfg)
    short = M.init_cache(cfg, 2, 12, device="cpu")
    assert [s["attn"]["k"].shape[3] for s in short["slots"]] == [12] * 3
    assert M.cache_capacity(short, cfg) == 12
    with pytest.raises(ValueError):
        M.check_cache_fits(short, 12, cfg)
    assert M.cache_capacity(M.init_cache(cfg, 2, W, device="cpu"), cfg) == W
    # a stack of rings alone never overflows
    local = dataclasses.replace(cfg, block_unit=("attn_local",))
    assert M.cache_capacity(M.init_cache(local, 1, MAX_SEQ, device="cpu"),
                            local) is None


def test_decode_step_checks_capacity_past_the_rings():
    """``decode_step`` / ``decode_step_layered`` refuse a write past the
    global cache, and take positions past the ring's length."""
    _, cfg, _, params = _build()
    cache = M.to_decode_dtypes(cfg, M.init_cache(
        cfg, B, 24, dtype=torch.float32, device="cpu"))
    tok = torch.zeros((B, 1), dtype=torch.long)
    M.decode_step_layered(params, cfg, cache, 20, tok)
    M.decode_step(params, cfg, cache, np.array([21, 22]), tok)
    for fn in (M.decode_step_layered, M.decode_step):
        with pytest.raises(ValueError, match="overflow"):
            fn(params, cfg, cache, 24, tok)


def test_cli_serves_gemma(capsys):
    """``--arch gemma3-12b --smoke --attn-mask sliding`` on the CPU: sparse
    and dense print the same token ids."""
    out = {}
    for impl in ("sparse", "dense"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen",
                    "4", "--attn-mask", "sliding", "--attn-mask-impl", impl])
        text = capsys.readouterr().out
        out[impl] = text[text.index("sample generations"):]
    assert out["sparse"] == out["dense"]
