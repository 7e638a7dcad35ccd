"""Port vs reference: the dense GQA family serving on the CPU.

qwen3-1.7b (qk_norm), qwen2-1.5b (qkv bias, GQA group 3 in SMOKE, 6 in
CONFIG) and nemotron-4-340b (squared-ReLU MLP, GQA group 3 in SMOKE, 12 in
CONFIG at head dim 192) are stacks of plain ``attn`` layers.  Each test is
one case a family, held on its SMOKE config (f32 policy; weights from the
reference's ``init_params`` through ``interop.params_from_jax``, qwen2's
zero biases replaced by numpy-seeded ones on both sides so that the bias
path is exercised; prompts from numpy seeds):

* the configs, field for field, and the params' tree;
* ``model.prefill`` logits and caches at S 8 / 16 / 20: logits within 1e-4
  and f32 caches within 1e-5 of their largest |value|;
* decode steps at an int and at a ``(B,)`` position against the
  reference's ``decode_step`` (the same bounds), the vector path
  ``torch.equal`` to the int path at equal positions;
* masked prefill (``local_global``: the port's plain K4s against the
  reference's kernels in interpret mode, within 1e-4; K4m ``torch.equal``
  to K4s);
* greedy ``ServeScheduler`` tokens (fused and two-phase) equal to the
  reference's gather scheduler and to each request alone through
  ``ServeLoop``; fused == layered ``ServeLoop`` (tokens, first decode
  logits ``torch.equal``, greedy and at 0.7); int8-KV serving fused ==
  layered and each scheduled request == alone; the CLI.

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
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(2)
ARCHS = ["qwen3-1.7b", "qwen2-1.5b", "nemotron-4-340b"]
B = 2
MAX_SEQ = 32
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


def _with_biases(rparams):
    """The reference's tree with every ``bq`` / ``bk`` / ``bv`` leaf
    replaced by N(0, 0.1) values from numpy seed 17 (``init_params`` gives
    zeros, which would leave the bias add unexercised)."""
    rng = np.random.default_rng(17)
    slots = []
    for slot in rparams["blocks"]:
        attn = dict(slot["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(
                rng.normal(0.0, 0.1, attn[name].shape).astype(np.float32))
        slots.append({**slot, "attn": attn})
    return {**rparams, "blocks": tuple(slots)}


@functools.lru_cache(maxsize=None)
def _build(arch):
    rcfg = dataclasses.replace(r_get_smoke(arch), policy="f32")
    cfg = dataclasses.replace(configs.get_smoke(arch), policy="f32")
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    rparams = jax.device_get(rparams)
    if cfg.qkv_bias:
        rparams = _with_biases(rparams)
    params = params_from_jax(rparams, cfg, device="cpu")
    return rcfg, cfg, rparams, params


def _prompts(arch, S, seed=None, rows=B):
    cfg = _build(arch)[1]
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

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_reference(arch, which):
    """``get_config`` / ``get_smoke`` field for field the reference's, and
    the family's shape: plain ``attn`` layers only."""
    get = {"CONFIG": (configs.get_config, r_get_config),
           "SMOKE": (configs.get_smoke, r_get_smoke)}[which]
    cfg = get[0](arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(get[1](arch))
    assert arch in configs.ARCH_NAMES
    assert cfg.family == "dense" and cfg.block_unit == ("attn",)
    full = configs.get_config(arch)
    assert (full.hd, full.n_heads // full.n_kv_heads) == {
        "qwen3-1.7b": (128, 2), "qwen2-1.5b": (128, 6),
        "nemotron-4-340b": (192, 12)}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_params_tree_and_biases(arch):
    """The reference's tree converts leaf for leaf into ``init_params``'s
    tree; qwen2's biases arrive nonzero and move the logits."""
    rcfg, cfg, rparams, params = _build(arch)
    mine = M.init_params(cfg, device="cpu")
    shapes = lambda t: [(x.shape, x.dtype) for x in _leaves(t)]  # noqa: E731
    assert shapes(mine) == shapes(params)
    attn = params["blocks"][0]["attn"]
    assert ("bq" in attn) == cfg.qkv_bias
    assert ("q_norm" in attn) == cfg.qk_norm
    assert ("w_gate" in params["blocks"][0]["ffn"]) == \
        (cfg.mlp_type == "swiglu")
    if cfg.qkv_bias:
        assert all(bool(attn[b].abs().min() > 0) for b in ("bq", "bk", "bv"))
        toks = torch.from_numpy(_prompts(arch, 8)).long()
        zero = {**params, "blocks": tuple(
            {**s, "attn": {**s["attn"], **{b: torch.zeros_like(s["attn"][b])
                                           for b in ("bq", "bk", "bv")}}}
            for s in params["blocks"])}
        a, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
        z, _, _ = M.prefill(zero, toks, cfg, max_seq=MAX_SEQ)
        assert not torch.equal(a, z)


@pytest.mark.parametrize("arch", ARCHS)
def test_mlp_matches_reference(arch):
    """``apply_mlp`` (swiglu or squared ReLU) against the reference's on
    the first layer's weights, within 1e-5."""
    from repro.models import layers as RL
    rcfg, cfg, rparams, params = _build(arch)
    x = np.random.default_rng(3).normal(size=(2, 5, cfg.d_model)).astype(
        np.float32)
    rffn = jax.tree.map(lambda t: t[0], rparams["blocks"][0]["ffn"])
    ffn = {k: v[0] for k, v in params["blocks"][0]["ffn"].items()}
    want = RL.apply_mlp(rffn, jnp.asarray(x), rcfg)
    _close(L.apply_mlp(ffn, torch.from_numpy(x), cfg), want, 1e-5,
           f"{arch} mlp")


# --------------------------------------------------------------- prefill --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [8, 16, 20])
def test_prefill_logits_and_caches_match_reference(arch, S):
    """``M.prefill`` against the reference's: logits within 1e-4, f32
    caches within 1e-5."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts = _prompts(arch, S)
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ, cache_dtype=jnp.float32)
    logits, cache, pos = M.prefill(params, torch.from_numpy(prompts).long(),
                                   cfg, max_seq=MAX_SEQ,
                                   cache_dtype=torch.float32)
    assert pos == int(rpos) == S
    _close(logits, rl, LOGIT_TOL, f"{arch} prefill S={S}")
    _close_caches(cache, rc, CACHE_TOL, f"{arch} prefill S={S}")


# ---------------------------------------------------------------- decode --

def _stacked_prefill(arch, lengths):
    """Each row's prompt prefilled alone (B = 1) on both sides, the rows'
    caches concatenated: rows at their own positions."""
    rcfg, cfg, rparams, params = _build(arch)
    rows, rrows, firsts = [], [], []
    for i, S in enumerate(lengths):
        pr = _prompts(arch, S, seed=100 + i, rows=1)
        rl, rc, _ = RM.prefill(rparams, jnp.asarray(pr), rcfg,
                               max_seq=MAX_SEQ, cache_dtype=jnp.float32)
        _, c, _ = M.prefill(params, torch.from_numpy(pr).long(), cfg,
                            max_seq=MAX_SEQ, cache_dtype=torch.float32)
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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,lengths", [("int", (12, 12)),
                                          ("vector", (9, 14))])
def test_decode_matches_reference(arch, kind, lengths):
    """Six decode steps at an int and at a ``(B,)`` position against the
    reference's ``decode_step``: logits within 1e-4, f32 caches within
    1e-5 after the last step; at equal positions the vector path
    ``torch.equal`` to the int path."""
    rcfg, cfg, rparams, params = _build(arch)
    cache, rcache, tok = _stacked_prefill(arch, lengths)
    pos = np.array(lengths)
    for _ in range(6):
        p = int(pos[0]) if kind == "int" else pos
        rlg, rcache = RM.decode_step(rparams, rcfg, rcache,
                                     jnp.asarray(p, jnp.int32),
                                     jnp.asarray(tok), dtype=jnp.float32)
        lg, cache = M.decode_step_layered(params, cfg, cache, p,
                                          torch.from_numpy(tok).long())
        _close(lg, rlg, LOGIT_TOL, f"{arch} decode at {pos}")
        tok = np.argmax(np.asarray(rlg)[:, -1, :cfg.vocab_size],
                        -1)[:, None].astype(np.int32)
        pos = pos + 1
    _close_caches(cache, rcache, CACHE_TOL, f"{arch} decode to {pos}")
    if kind == "int":
        c_int, _, tok0 = _stacked_prefill(arch, lengths)
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


# ---------------------------------------------------------------- masked --

@pytest.mark.parametrize("arch", ARCHS)
def test_masked_prefill_matches_reference(arch):
    """``attn_mask=local_global`` prefill (window 8): the port's plain K4s
    against the reference's masked prefill (its kernels in interpret
    mode), logits within 1e-4 and f32 caches within 1e-5; K4m
    (``impl="dense"``) ``torch.equal`` to K4s."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts = _prompts(arch, 24, seed=7)
    rl, rc, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                           max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                           attn_mask=RAttnMaskSpec(pattern="local_global",
                                                   window=8))
    toks = torch.from_numpy(prompts).long()
    out = {impl: M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                           cache_dtype=torch.float32,
                           attn_mask=AttnMaskSpec(pattern="local_global",
                                                  window=8, impl=impl))
           for impl in ("sparse", "dense")}
    _close(out["sparse"][0], rl, LOGIT_TOL, f"{arch} masked prefill")
    _close_caches(out["sparse"][1], rc, CACHE_TOL, f"{arch} masked")
    assert torch.equal(out["sparse"][0], out["dense"][0])


# ------------------------------------------------------------ scheduling --

def _trace(arch):
    """Four requests: prompts of 6-15 tokens, budgets 4-9."""
    cfg = _build(arch)[1]
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
def _reference_tokens(arch):
    rcfg, _, rparams, _ = _build(arch)
    return _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch="gather"),
                  _trace(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("two_phase", [False, True])
def test_scheduler_matches_reference_and_alone(arch, two_phase):
    """Greedy ``ServeScheduler`` tokens (fused: one decode step a bucket
    over the pool's rows; two-phase: layered) == the reference's gather
    scheduler's, per request, and == each request alone through
    ``ServeLoop``."""
    _, cfg, _, params = _build(arch)
    reqs = _trace(arch)
    got = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                device="cpu", two_phase=two_phase), reqs)
    want = _reference_tokens(arch)
    assert sorted(got) == sorted(want)
    for uid in want:
        assert np.array_equal(got[uid], want[uid]), uid
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], got[uid]), uid


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_fused_equals_layered(arch, temperature):
    """``ServeLoop`` fused (``model.decode_step`` on its static buffers,
    the default) and layered give the same tokens, and the same first
    decode step logits, ``torch.equal``."""
    _, cfg, _, params = _build(arch)
    assert not ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu").two_phase
    prompts = _prompts(arch, 14, seed=11)
    out = {}
    for two_phase in (False, True):
        loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                         two_phase=two_phase, temperature=temperature)
        seen = []

        def keep(last, _s=loop._sample):
            seen.append(last.clone())
            return _s(last)

        loop._sample = keep
        out[two_phase] = (loop.run(prompts, 8), seen[1])
    assert np.array_equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_quant_serving_fused_equals_layered_and_alone(arch):
    """int8 KV: ``prefill`` logits ``torch.equal`` to wide; ``ServeLoop``
    fused == layered tokens; the fused scheduler's requests == alone under
    the same ``kv_quant``."""
    _, cfg, _, params = _build(arch)
    prompts = _prompts(arch, 12, seed=9)
    toks = torch.from_numpy(prompts).long()
    wide, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    narrow, cache, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                 kv_quant="int8")
    assert torch.equal(wide, narrow)
    assert cache["slots"][0]["attn"]["k"].dtype == torch.int8
    got = [ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     two_phase=tp, kv_quant="int8").run(prompts, 8)
           for tp in (False, True)]
    assert np.array_equal(*got)
    reqs = _trace(arch)
    sched = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                  device="cpu", kv_quant="int8"), reqs)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     kv_quant="int8")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], sched[uid]), uid


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves(arch, capsys):
    """``--arch <name> --smoke`` on the CPU, static and ``--continuous``:
    token ids printed, the same ids under ``--two-phase on``."""
    out = {}
    for extra in ([], ["--two-phase", "on"]):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--gen",
                    "4", *extra])
        text = capsys.readouterr().out
        out[tuple(extra)] = text[text.index("sample generations"):]
    assert out[()] == out[("--two-phase", "on")]
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--continuous", "--requests", "3", "--slots", "2"])
    assert "tok/s" in capsys.readouterr().out
