"""Port vs reference: llama4-maverick-400b-a17b serving on the CPU.

Maverick is the one stack that interleaves dense and MoE layers
(``block_unit=("attn", "attn+moe")``) and the one with 128 routed experts.
Held on its SMOKE config (f32 policy; weights from the reference's
``init_params`` through ``interop.params_from_jax``; prompts from numpy
seeds):

* the configs field for field and ``param_count``, every name of the
  reference's registry served by the port; the params' tree (the ``attn``
  slot an MLP, the ``attn+moe`` slot ``router`` / ``experts`` /
  ``shared``) and the decode cache (MoE counts in the attn+moe slot only,
  ``(n_repeats, B, E)``);
* ``model.prefill`` (fused) and ``prefill_layered`` (two-phase bcsr)
  logits within 1e-4 and f32 caches within 1e-5 of their largest |value|
  at S 8 / 16 / 20; three decode steps at an int and at a ``(B,)``
  position within 1e-4, the fused step at the vector ``torch.equal`` to
  the layered one at the int;
* greedy ``ServeLoop`` tokens (two-phase bcsr, fused bcsr, fused gather)
  == the reference's gather ``ServeLoop`` (its bcsr two-phase path raises
  ``ShardingTypeError`` on this jax; gather is bit-identical to it by
  contract); depth 1 == depth 0 with a route stage at the attn+moe layers
  only; fused == layered at T 0 and 0.7; the scheduler (two-phase and
  fused) == the reference's gather scheduler and == each request alone;
  int8 KV fused == layered and == alone;
* ``quantize_model_experts`` on the interleaved stack: the dense slot
  untouched, the MoE slot's ``QuantTensor`` bitwise the reference's
  ``quantize_expert_weights``; the ``local_global`` masked prefill (K4s
  within 1e-4 of the reference's interpret-mode kernels, K4m ``torch.equal``
  to K4s); the CLI, with ``--quantize-experts int8`` too.

SMOKE has 4 experts, so the E-128 paths are held on SMOKE with
``n_experts=128, capacity_factor=1.25`` at S 256, where the capacity is 3
and tokens drop: ``route_tokens``, the routed stream and its bucket, the
full grid (48 x 32 blocks at 4 x 256, 16 block rows at decode), and
``apply_moe`` bcsr == gather bit for bit and equal to the reference.

Tokens are compared exactly, never within a tolerance.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import get_config as r_get_config
from repro.configs import get_smoke as r_get_smoke
from repro.core.masks import AttnMaskSpec as RAttnMaskSpec
from repro.launch.serve import ServeLoop as RServeLoop
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models import moe as rmoe

from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.core.precision import QuantTensor
from repro_torch.interop import params_from_jax, quant_tensor_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.models import moe

torch.set_num_threads(2)
ARCH = "llama4-maverick-400b-a17b"
B, MAX_SEQ, GEN = 2, 32, 6
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
# the two-phase MoE stage: route_moe, then execute_moe with the bcsr stream
_two_phase = functools.partial(moe.apply_moe, dispatch="bcsr")


@functools.lru_cache(maxsize=None)
def _build(wide: bool = False):
    """SMOKE in f32 (``wide``: with 128 experts at ``capacity_factor``
    1.25), the reference's params and the port's copy of them."""
    kw = dict(policy="f32")
    if wide:
        kw.update(n_experts=128, capacity_factor=1.25)
    rcfg = dataclasses.replace(r_get_smoke(ARCH), **kw)
    cfg = dataclasses.replace(configs.get_smoke(ARCH), **kw)
    rparams = jax.device_get(jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, rparams, params_from_jax(rparams, cfg, device="cpu")


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


def _close_caches(cache, rcache, what):
    """K / V within CACHE_TOL; the MoE occupancy equal."""
    for i, (slot, rslot) in enumerate(zip(cache["slots"], rcache["slots"])):
        assert sorted(slot) == sorted(rslot), (what, i)
        for name, leaf in slot["attn"].items():
            _close(leaf, rslot["attn"][name], CACHE_TOL,
                   f"{what} slot {i} {name}")
        if "moe" in slot:
            np.testing.assert_array_equal(slot["moe"].numpy(),
                                          np.asarray(rslot["moe"]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(_map(fn, *ts) for ts in zip(*trees))
    return fn(*trees)


def _greedy(logits, cfg):
    return np.argmax(np.asarray(logits)[:, -1, :cfg.vocab_size],
                     -1)[:, None].astype(np.int32)


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_reference(which):
    """``get_config`` / ``get_smoke`` field for field the reference's, the
    same ``param_count``, and the stack's shape: dense and MoE layers
    interleaved, 128 experts top-1 with a shared expert in CONFIG."""
    get = {"CONFIG": (configs.get_config, r_get_config),
           "SMOKE": (configs.get_smoke, r_get_smoke)}[which]
    cfg, rcfg = get[0](ARCH), get[1](ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert cfg.block_unit == ("attn", "attn+moe") and cfg.moe_shared_expert
    full = configs.get_config(ARCH)
    assert (full.n_experts, full.top_k, full.n_repeats, full.capacity_factor,
            full.d_model, full.d_ff) == (128, 1, 24, 1.25, 5120, 8192)


def test_every_reference_arch_is_ported():
    """No name of the reference's registry raises in the port; a name in
    no registry still does."""
    assert sorted(configs.ARCH_NAMES) == sorted(rconfigs.ARCH_NAMES)
    for name in rconfigs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(r_get_config(name))
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get_smoke("llama4-behemoth")


def test_params_tree_and_cache_layout():
    """The reference's tree converts leaf for leaf into ``init_params``'s:
    the ``attn`` slot's FFN a swiglu MLP, the ``attn+moe`` slot's the
    router, the stacked experts and the shared expert.  ``init_cache``
    has the reference's leaves and shapes, the MoE counts only in the
    attn+moe slot, ``(n_repeats, B, n_experts)`` int32."""
    rcfg, cfg, rparams, params = _build()
    mine = M.init_params(cfg, device="cpu")
    shapes = lambda t: [(x.shape, x.dtype) for x in _leaves(t)]  # noqa: E731
    assert shapes(mine) == shapes(params)
    dense, sparse = (params["blocks"][i]["ffn"] for i in (0, 1))
    assert sorted(dense) == ["w_down", "w_gate", "w_up"]
    assert sorted(sparse) == ["experts", "router", "shared"]
    E, n = cfg.n_experts, cfg.n_repeats
    assert sparse["router"].shape == (n, cfg.d_model, E)
    assert sparse["experts"]["w_gate"].shape == (n, E, cfg.d_model, cfg.d_ff)
    cache = M.init_cache(cfg, 3, MAX_SEQ, device="cpu")
    want = jax.eval_shape(lambda: RM.init_cache(rcfg, 3, MAX_SEQ))
    assert [sorted(s) for s in cache["slots"]] == [["attn"], ["attn", "moe"]]
    assert [sorted(s) for s in want["slots"]] == [["attn"], ["attn", "moe"]]
    assert cache["slots"][1]["moe"].shape == (n, 3, E) \
        == want["slots"][1]["moe"].shape
    assert cache["slots"][1]["moe"].dtype == torch.int32
    for got, ref in zip(_leaves(cache), jax.tree_util.tree_leaves(want)):
        assert tuple(got.shape) == tuple(ref.shape)


def test_init_draws_a_large_slice_in_pieces(monkeypatch):
    """``layers.normal`` draws a repeat slice of at most ``DRAW_BYTES`` in
    f32 as one ``randn`` (so every slice below it keeps its values) and a
    larger one (maverick's stacked experts) in pieces along its first dim,
    each piece the generator's next draw."""
    from repro_torch.models import layers as L

    def draw(shape, n, budget):
        monkeypatch.setattr(L, "DRAW_BYTES", budget)
        return L.normal(torch.Generator().manual_seed(3), shape, 0.5, n=n,
                        dtype=torch.float32, device="cpu")

    g = torch.Generator().manual_seed(3)
    whole = torch.stack([torch.randn((6, 4, 5), generator=g) * 0.5
                         for _ in range(2)])
    assert torch.equal(draw((6, 4, 5), 2, 4 * 6 * 4 * 5), whole)
    g = torch.Generator().manual_seed(3)
    pieces = torch.stack([torch.cat([torch.randn((k, 4, 5), generator=g)
                                     * 0.5 for k in (4, 2)])
                          for _ in range(2)])
    assert torch.equal(draw((6, 4, 5), 2, 4 * 4 * 4 * 5 + 7), pieces)


# --------------------------------------------------------------- prefill --

@pytest.mark.parametrize("entry", ["prefill", "prefill_layered"])
@pytest.mark.parametrize("S", [8, 16, 20])
def test_prefill_matches_reference(entry, S):
    """The fused ``M.prefill`` (gather) and the two-phase
    ``prefill_layered`` (bcsr, the routed stream) against the reference's
    ``prefill``: logits within 1e-4, f32 caches within 1e-5, the MoE
    occupancy equal."""
    rcfg, cfg, rparams, params = _build()
    prompts = _prompts(S)
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ, cache_dtype=jnp.float32)
    kw = {"moe_fn": _two_phase} if entry == "prefill_layered" else {}
    logits, cache, pos = getattr(M, entry)(
        params, torch.from_numpy(prompts).long(), cfg, max_seq=MAX_SEQ,
        cache_dtype=torch.float32, **kw)
    assert pos == int(rpos) == S
    _close(logits, rl, LOGIT_TOL, f"{entry} S={S}")
    _close_caches(cache, rc, f"{entry} S={S}")


# ---------------------------------------------------------------- decode --

def _stacked_prefill(lengths):
    """Each row's prompt prefilled alone (B = 1) on both sides, the rows'
    caches (K / V and MoE counts) concatenated: rows at their own
    positions."""
    rcfg, cfg, rparams, params = _build()
    rows, rrows, firsts = [], [], []
    for i, S in enumerate(lengths):
        pr = _prompts(S, seed=100 + i, rows=1)
        rl, rc, _ = RM.prefill(rparams, jnp.asarray(pr), rcfg,
                               max_seq=MAX_SEQ, cache_dtype=jnp.float32)
        _, c, _ = M.prefill(params, torch.from_numpy(pr).long(), cfg,
                            max_seq=MAX_SEQ, cache_dtype=torch.float32)
        rows.append(c)
        rrows.append(rc)
        firsts.append(_greedy(rl, cfg)[0])
    cache = _map(lambda *xs: torch.cat(xs, 1), *rows)
    rcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, 1), *rrows)
    return cache, rcache, np.stack(firsts)


@pytest.mark.parametrize("kind,lengths", [("int", (12, 12)),
                                          ("vector", (9, 14))])
def test_decode_matches_reference(kind, lengths):
    """Three two-phase decode steps (``decode_step_layered``, bcsr) at an
    int and at a ``(B,)`` position against the reference's
    ``decode_step``: logits within 1e-4, f32 caches within 1e-5 and the
    MoE occupancy equal after the last step.  At equal positions the fused
    step at a vector ``torch.equal`` to the layered step at the int."""
    rcfg, cfg, rparams, params = _build()
    cache, rcache, tok = _stacked_prefill(lengths)
    pos = np.array(lengths)
    for _ in range(3):
        p = int(pos[0]) if kind == "int" else pos
        rlg, rcache = RM.decode_step(rparams, rcfg, rcache,
                                     jnp.asarray(p, jnp.int32),
                                     jnp.asarray(tok), dtype=jnp.float32)
        lg, cache = M.decode_step_layered(params, cfg, cache, p,
                                          torch.from_numpy(tok).long(),
                                          moe_fn=_two_phase)
        _close(lg, rlg, LOGIT_TOL, f"decode at {pos}")
        tok = _greedy(rlg, cfg)
        pos = pos + 1
    _close_caches(cache, rcache, f"decode to {pos}")
    if kind == "int":
        c_int, _, tok0 = _stacked_prefill(lengths)
        c_vec = _map(torch.clone, c_int)
        t = torch.from_numpy(tok0).long()
        a, _ = M.decode_step_layered(params, cfg, c_int, lengths[0], t,
                                     moe_fn=_two_phase)
        b, _ = M.decode_step(params, cfg, c_vec, torch.tensor(list(lengths)),
                             t, dispatch="bcsr")
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in
                   zip(_leaves(c_int), _leaves(c_vec)))


# --------------------------------------------------------------- serving --

@functools.lru_cache(maxsize=None)
def _reference_loop_tokens():
    rcfg, _, rparams, _ = _build()
    return RServeLoop(rparams, rcfg, max_seq=MAX_SEQ, dispatch="gather").run(
        jnp.asarray(_prompts(14, seed=11)), GEN)


@pytest.mark.parametrize("dispatch,two_phase", [("bcsr", True),
                                                ("bcsr", False),
                                                ("gather", False)])
def test_serve_loop_matches_reference(dispatch, two_phase):
    """Greedy ``ServeLoop`` tokens == the reference's gather ``ServeLoop``;
    two-phase, one route and one execute a MoE layer a pass (none at the
    dense layers)."""
    _, cfg, _, params = _build()
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                     two_phase=two_phase, device="cpu")
    got = loop.run(_prompts(14, seed=11), GEN)
    np.testing.assert_array_equal(got, _reference_loop_tokens())
    if two_phase:
        s = loop.summary()
        n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
        assert s["route"]["calls"] == s["execute"]["calls"] == GEN * n_moe


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_depth1_equals_depth0(temperature):
    """``pipeline_depth=1`` (route phase 1 with the attention half of each
    attn+moe layer, nothing carried across the dense layer before it)
    gives the depth-0 tokens, with ``n_moe`` route calls a pass."""
    _, cfg, _, params = _build()
    prompts = _prompts(14, seed=12)
    got = {}
    for depth in (0, 1):
        loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="bcsr",
                         pipeline_depth=depth, temperature=temperature,
                         device="cpu")
        got[depth] = loop.run(prompts, GEN)
        n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
        assert loop.summary()["route"]["calls"] == GEN * n_moe
    np.testing.assert_array_equal(got[0], got[1])


def test_route_ahead_only_at_moe_layers(monkeypatch):
    """The route-ahead prefill and decode dispatch route phase 1 once an
    attn+moe layer, never at a dense layer, and give the values of
    ``route_ahead=False``."""
    _, cfg, _, params = _build()
    calls = []
    entry = moe.route_phase1

    def counted(router, x, *a, **kw):
        calls.append(tuple(x.shape))
        return entry(router, x, *a, **kw)

    monkeypatch.setattr(moe, "route_phase1", counted)
    toks = torch.from_numpy(_prompts(12, seed=13)).long()

    def moe_fn(p, h, c, counts=None, pos=None, phase1=None):
        return moe.apply_moe(p, h, c, counts=counts, pos=pos,
                             dispatch="bcsr")

    out = {}
    for ahead in (False, True):
        calls.clear()
        lg, cache, pos = M.prefill_layered(params, toks, cfg, max_seq=MAX_SEQ,
                                           moe_fn=moe_fn, route_ahead=ahead,
                                           cache_dtype=torch.float32)
        n_pre = len(calls)
        dl, _ = M.decode_step_layered(params, cfg, cache, pos,
                                      toks[:, :1], moe_fn=moe_fn,
                                      route_ahead=ahead)
        out[ahead] = (lg, dl, n_pre, len(calls) - n_pre)
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    # each MoE layer routes once in moe_fn; route-ahead once more with its
    # attention half
    assert out[False][2:] == (n_moe, n_moe)
    assert out[True][2:] == (2 * n_moe, 2 * n_moe)
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_fused_equals_layered(temperature):
    """``ServeLoop`` fused (the default for gather) and layered give the
    same tokens and the same first decode step logits, ``torch.equal``."""
    _, cfg, _, params = _build()
    prompts = _prompts(14, seed=14)
    out = {}
    for two_phase in (False, True):
        loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                         dispatch="gather", two_phase=two_phase,
                         temperature=temperature)
        seen = []

        def keep(last, _s=loop._sample):
            seen.append(last.clone())
            return _s(last)

        loop._sample = keep
        out[two_phase] = (loop.run(prompts, 8), seen[1])
    assert np.array_equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


def _trace():
    """Four requests: prompts of 6-15 tokens, budgets 4-9."""
    cfg = _build()[1]
    rng = np.random.default_rng(0)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(6, 16))
                          ).astype(np.int32), int(rng.integers(4, 10)))
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
def _reference_sched_tokens():
    rcfg, _, rparams, _ = _build()
    return _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch="gather"), _trace())


@pytest.mark.parametrize("two_phase", [False, True])
def test_scheduler_matches_reference_and_alone(two_phase):
    """Greedy ``ServeScheduler`` tokens (bcsr; fused on the full grid, or
    two-phase on the routed stream) == the reference's gather scheduler's,
    per request, and == each request alone through ``ServeLoop``."""
    _, cfg, _, params = _build()
    reqs = _trace()
    got = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                dispatch="bcsr", two_phase=two_phase,
                                device="cpu"), reqs)
    want = _reference_sched_tokens()
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    for uid, (p, g) in enumerate(reqs):
        np.testing.assert_array_equal(loop.run(p[None], g)[0], got[uid])


def test_kv_quant_serving_fused_equals_layered_and_alone():
    """int8 KV: ``prefill`` logits ``torch.equal`` to wide; ``ServeLoop``
    fused == layered tokens; the fused scheduler's requests == alone under
    the same ``kv_quant``."""
    _, cfg, _, params = _build()
    prompts = _prompts(12, seed=9)
    toks = torch.from_numpy(prompts).long()
    wide, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    narrow, cache, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                 kv_quant="int8")
    assert torch.equal(wide, narrow)
    assert all(s["attn"]["k"].dtype == torch.int8 for s in cache["slots"])
    got = [ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     two_phase=tp, kv_quant="int8").run(prompts, 8)
           for tp in (False, True)]
    np.testing.assert_array_equal(*got)
    reqs = _trace()
    sched = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                  device="cpu", kv_quant="int8"), reqs)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     kv_quant="int8")
    for uid, (p, g) in enumerate(reqs):
        np.testing.assert_array_equal(loop.run(p[None], g)[0], sched[uid])


@pytest.mark.parametrize("dtype", ["int8", "fp8_e4m3"])
def test_quantize_model_experts_interleaved(dtype):
    """``quantize_model_experts`` on the interleaved stack: the dense
    slot is the params' own (untouched), the MoE slot's experts each a
    ``QuantTensor`` bitwise the reference's ``quantize_expert_weights`` of
    that slot (and of its ``quantize_model_experts``), router and shared
    expert untouched."""
    _, cfg, rparams, params = _build()
    got = moe.quantize_model_experts(params, dtype)
    assert got["blocks"][0] is params["blocks"][0]
    ffn, qffn = params["blocks"][1]["ffn"], got["blocks"][1]["ffn"]
    assert qffn["router"] is ffn["router"] and qffn["shared"] is ffn["shared"]
    slot = rmoe.quantize_expert_weights(rparams["blocks"][1]["ffn"], dtype)
    whole = rmoe.quantize_model_experts(rparams, dtype)
    for want_tree in (slot, whole["blocks"][1]["ffn"]):
        for name, qt in qffn["experts"].items():
            ref = quant_tensor_from_jax(jax.device_get(
                want_tree["experts"][name]), device="cpu")
            assert isinstance(qt, QuantTensor) and qt.axis == ref.axis == -2
            assert torch.equal(qt.values.view(torch.uint8),
                               ref.values.view(torch.uint8)), name
            assert torch.equal(qt.scales, ref.scales), name


def test_masked_prefill_matches_reference():
    """``attn_mask=local_global`` prefill (window 8): the port's plain K4s
    against the reference's masked prefill (its kernels in interpret
    mode), logits within 1e-4 and f32 caches within 1e-5; K4m
    (``impl="dense"``) ``torch.equal`` to K4s."""
    rcfg, cfg, rparams, params = _build()
    prompts = _prompts(24, seed=7)
    rl, rc, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                           max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                           attn_mask=RAttnMaskSpec(pattern="local_global",
                                                   window=8))
    toks = torch.from_numpy(prompts).long()
    out = {impl: M.prefill_layered(
        params, toks, cfg, max_seq=MAX_SEQ, cache_dtype=torch.float32,
        moe_fn=_two_phase,
        attn_mask=AttnMaskSpec(pattern="local_global", window=8, impl=impl))
        for impl in ("sparse", "dense")}
    _close(out["sparse"][0], rl, LOGIT_TOL, "masked prefill")
    _close_caches(out["sparse"][1], rc, "masked prefill")
    assert torch.equal(out["sparse"][0], out["dense"][0])


@pytest.mark.parametrize("extra", [[], ["--quantize-experts", "int8"]])
def test_cli_serves(extra, capsys):
    """``--arch llama4-maverick-400b-a17b --smoke`` on the CPU: the same
    token ids fused and two-phase (``--two-phase on``), with int8 experts
    too; ``--continuous`` serves."""
    out = {}
    for mode in ("off", "on"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen",
                    "4", "--dispatch", "bcsr", "--two-phase", mode, *extra])
        text = capsys.readouterr().out
        out[mode] = text[text.index("sample generations"):]
    assert out["off"] == out["on"]
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--continuous",
                "--requests", "3", "--slots", "2", *extra])
    assert "tok/s" in capsys.readouterr().out


# ------------------------------------------------- 128 experts, drops --

WIDE_B, WIDE_S = 4, 256


@functools.lru_cache(maxsize=None)
def _wide_layer():
    """The E-128 narrow config's first MoE layer (the reference's and the
    port's) and a numpy-seeded (4, 256, 64) hidden state."""
    rcfg, cfg, rparams, params = _build(wide=True)
    rp = jax.tree.map(lambda t: t[0], rparams["blocks"][1]["ffn"])
    p = M._take(params["blocks"][1]["ffn"], 0)
    x = np.random.default_rng(5).standard_normal(
        (WIDE_B, WIDE_S, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, p, x


def test_wide_route_tokens_match_reference():
    """At E 128 and S 256 the prefix capacity is 3 and tokens drop:
    expert, slot, keep and counts equal the reference's, the gate within
    1e-6; a decode step at position 256 with the carried counts too."""
    rcfg, cfg, rp, p, x = _wide_layer()
    assert moe.dispatch_capacity(WIDE_S, cfg) == \
        rmoe.dispatch_capacity(WIDE_S, rcfg) == 3
    want = rmoe.route_tokens(rp["router"], jnp.asarray(x), rcfg)
    got = moe.route_tokens(p["router"], torch.from_numpy(x), cfg)
    assert int((~got.keep).sum()) > 0, "E 128 at S 256 must drop tokens"
    for f in ("expert_id", "slot", "within", "keep", "new_counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want.gate),
                               atol=1e-6, rtol=0)
    w1 = rmoe.route_tokens(rp["router"], jnp.asarray(x[:, :1]), rcfg,
                           counts=want.new_counts, pos0=WIDE_S)
    g1 = moe.route_tokens(p["router"], torch.from_numpy(x[:, :1]), cfg,
                          counts=got.new_counts, pos0=WIDE_S)
    for f in ("expert_id", "slot", "keep", "new_counts"):
        np.testing.assert_array_equal(getattr(g1, f).numpy(),
                                      np.asarray(getattr(w1, f)), err_msg=f)


def test_wide_routed_stream_matches_reference():
    """The routed stream of the E-128 prefill: blocks, coordinates,
    ``nnzb_routed`` / ``nnzb_covered`` and the bucket the reference's; the
    plan's accounting at 48 x 32 blocks of 8 x 8."""
    rcfg, cfg, rp, p, x = _wide_layer()
    xt = torch.from_numpy(x)
    plan, info = moe.route_moe(p, xt, cfg, dispatch="bcsr")
    fs = plan.flat_slot.numpy()
    E, C = cfg.n_experts, plan.capacity
    want = rmoe._build_routed_stream(fs, WIDE_S, E, C, 8, 8, jnp.float32,
                                     min_bucket=8)
    got = moe._build_routed_stream(fs, WIDE_S, E, C, 8, 8, torch.float32,
                                   "cpu", min_bucket=8)
    assert got[1:] == want[1:]
    for f in ("indptr", "block_rows", "block_cols", "blocks"):
        np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                      np.asarray(getattr(want[0], f)))
    assert plan.stream.grid_shape == (48, 32)
    assert info["grid_nnzb"] == 48 * 32 and info["bucket"] == got[0].nnzb
    assert (info["nnzb_routed"], info["nnzb_covered"]) == want[1:]
    full, _ = moe.route_moe(p, xt, cfg, dispatch="bcsr", full_grid=True)
    assert full.stream.grid_shape == (48, 32) and full.stream.nnzb == 48 * 32


def test_wide_apply_moe_bcsr_equals_gather_and_reference():
    """At E 128 with drops: bcsr (the routed stream, and the full grid)
    == gather bit for bit, dispatch buffers and outputs; each within 1e-5
    of the reference's gather layer (f32 sums in another order)."""
    rcfg, cfg, rp, p, x = _wide_layer()
    xt = torch.from_numpy(x)
    want, wc = rmoe.apply_moe(rp, jnp.asarray(x), rcfg, dispatch="gather")
    outs = {}
    for key, kw in (("gather", dict(dispatch="gather")),
                    ("bcsr", dict(dispatch="bcsr")),
                    ("full", dict(dispatch="bcsr", full_grid=True))):
        outs[key] = moe.apply_moe(p, xt, cfg, **kw)
    for key in ("bcsr", "full"):
        assert torch.equal(outs[key][0], outs["gather"][0]), key
        assert torch.equal(outs[key][1], outs["gather"][1]), key
    _close(outs["gather"][0], want, 1e-5, "E 128 apply_moe")
    np.testing.assert_array_equal(outs["gather"][1].numpy(), np.asarray(wc))
    plan, _ = moe.route_moe(p, xt, cfg, dispatch="bcsr")
    E, C = cfg.n_experts, plan.capacity
    assert torch.equal(moe._dispatch_stream(xt, plan.stream, E, C),
                       moe._dispatch_gather(xt, plan.flat_slot, E, C))


def test_wide_decode_step_on_sixteen_block_rows():
    """A one-token decode step after the 256-token prefill: capacity 1,
    so M = 128 dispatch rows, 16 block rows of 8 on the full grid and in
    the routed stream; bcsr (both streams) == gather bit for bit and
    within 1e-5 of the reference, counts equal."""
    rcfg, cfg, rp, p, x = _wide_layer()
    _, counts = moe.apply_moe(p, torch.from_numpy(x), cfg)
    _, rcounts = rmoe.apply_moe(rp, jnp.asarray(x), rcfg)
    x1 = np.random.default_rng(6).standard_normal(
        (WIDE_B, 1, cfg.d_model)).astype(np.float32)
    xt = torch.from_numpy(x1)
    assert moe.dispatch_capacity(1, cfg, pos0=WIDE_S) == 1
    for full in (False, True):
        plan, _ = moe.route_moe(p, xt, cfg, counts=counts, pos=WIDE_S,
                                dispatch="bcsr", full_grid=full)
        assert plan.capacity == 1 and plan.stream.grid_shape == (16, 1)
    want, wc = rmoe.apply_moe(rp, jnp.asarray(x1), rcfg, counts=rcounts,
                              pos=WIDE_S, dispatch="gather")
    outs = [moe.apply_moe(p, xt, cfg, counts=counts, pos=WIDE_S, **kw)
            for kw in (dict(dispatch="gather"), dict(dispatch="bcsr"),
                       dict(dispatch="bcsr", full_grid=True))]
    for out, c in outs[1:]:
        assert torch.equal(out, outs[0][0]) and torch.equal(c, outs[0][1])
    _close(outs[0][0], want, 1e-5, "E 128 decode step")
    np.testing.assert_array_equal(outs[0][1].numpy(), np.asarray(wc))
