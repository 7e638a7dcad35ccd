"""Port vs reference: frontend embeddings on the CPU.

musicgen-large (an audio stub: 4 frame embeddings in SMOKE, 64 in CONFIG;
MHA) and internvl2-26b (a vision stub: 8 patch embeddings in SMOKE, 256 in
CONFIG; GQA group 2 in SMOKE, 6 in CONFIG) are stacks of plain ``attn``
layers whose prefill takes precomputed ``(B, frontend_tokens, d_model)``
embeddings, prepended to the token embeddings.  Each test is one case an
arch, held on its SMOKE config (f32 policy; weights from the reference's
``init_params`` through ``interop.params_from_jax``; prompts and
embeddings, 0.02 * N(0, 1), from numpy seeds, the same arrays on both
sides):

* the configs, field for field, and ``param_count``;
* ``model.prefill`` and ``prefill_layered`` with ``embeddings=`` at prompt
  lengths 8 and 13 (S_total 12 / 17 and 16 / 21): logits within 1e-4 and
  f32 caches within 1e-5 of their largest |value|, the next position
  S_total; a prefill past ``max_seq`` raises;
* f32 embeddings rounded once to the compute dtype (bf16 policy): the
  logits ``torch.equal`` to those of embeddings cast beforehand;
* three decode steps (fused and layered) from the reference's own prefill
  cache against its ``decode_step``: logits within 1e-4;
* masked prefill (``local_global``, window 8): the port's plain K4s
  against the reference's masked prefill within 1e-4, K4m ``torch.equal``
  to K4s;
* ``kv_quant="int8"``: prefill logits ``torch.equal`` to the wide ones;
* ``ServeLoop.run(embeddings=)`` (fused and layered) tokens == the
  reference's ``ServeLoop.run(embeddings=)`` (gather, greedy); fused ==
  layered (tokens, first decode logits ``torch.equal``) at T 0 and 0.7;
  ``max_seq`` counts the frontend positions;
* the scheduler's text-only requests (it takes no embeddings, as the
  reference's) == the reference's gather scheduler and == each alone;
* the CLI on ``--smoke --device cpu``.

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
from repro.launch.serve import ServeLoop as RServeLoop
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM

from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M

torch.set_num_threads(2)
ARCHS = ["musicgen-large", "internvl2-26b"]
B = 2
MAX_SEQ = 40
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _build(arch, policy="f32"):
    rcfg = dataclasses.replace(r_get_smoke(arch), policy=policy)
    cfg = dataclasses.replace(configs.get_smoke(arch), policy=policy)
    rparams = jax.device_get(jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    params = params_from_jax(rparams, cfg, device="cpu")
    return rcfg, cfg, rparams, params


def _prompts(arch, S, seed=None, rows=B):
    cfg = _build(arch)[1]
    return np.random.default_rng(S if seed is None else seed).integers(
        0, cfg.vocab_size, (rows, S)).astype(np.int32)


def _embeddings(arch, seed=50, rows=B):
    """0.02 * N(0, 1) frontend embeddings (rows, frontend_tokens, d), f32,
    as the reference's CLI makes them (its bits are jax.random's)."""
    cfg = _build(arch)[1]
    return (0.02 * np.random.default_rng(seed).standard_normal(
        (rows, cfg.frontend_tokens, cfg.d_model))).astype(np.float32)


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
    """``get_config`` / ``get_smoke`` field for field the reference's
    (``frontend``, ``frontend_tokens`` and ``rope_theta`` included), the
    same ``param_count``, and the family's shape."""
    get = {"CONFIG": (configs.get_config, r_get_config),
           "SMOKE": (configs.get_smoke, r_get_smoke)}[which]
    cfg, rcfg = get[0](arch), get[1](arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert arch in configs.ARCH_NAMES
    assert cfg.block_unit == ("attn",) and cfg.frontend_tokens > 0
    full = configs.get_config(arch)
    assert (full.frontend, full.frontend_tokens, full.hd,
            full.n_heads // full.n_kv_heads, full.rope_theta) == {
        "musicgen-large": ("audio", 64, 64, 1, 1e4),
        "internvl2-26b": ("vision", 256, 128, 6, 1e6)}[arch]


# --------------------------------------------------------------- prefill --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [8, 13])
def test_prefill_matches_reference(arch, S):
    """``M.prefill`` and ``M.prefill_layered`` with ``embeddings=`` against
    the reference's ``prefill``: logits within 1e-4, f32 caches within
    1e-5; the next position S_total = frontend positions + S on both
    sides; the two port entry points ``torch.equal``."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts, emb = _prompts(arch, S), _embeddings(arch)
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ, embeddings=jnp.asarray(emb),
                              cache_dtype=jnp.float32)
    toks, e = torch.from_numpy(prompts).long(), torch.from_numpy(emb)
    logits, cache, pos = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                   embeddings=e, cache_dtype=torch.float32)
    assert pos == int(rpos) == cfg.frontend_tokens + S
    _close(logits, rl, LOGIT_TOL, f"{arch} prefill S={S}")
    _close_caches(cache, rc, CACHE_TOL, f"{arch} prefill S={S}")
    lw, cw, pw = M.prefill_layered(params, toks, cfg, max_seq=MAX_SEQ,
                                   embeddings=e, cache_dtype=torch.float32)
    assert pw == pos and torch.equal(lw, logits)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(cw), _leaves(cache)))
    # the frontend moves the logits, and a prefill past max_seq is refused
    plain, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    assert not torch.equal(plain, logits)
    with pytest.raises(ValueError, match="max_seq"):
        M.prefill(params, toks, cfg, max_seq=pos - 1, embeddings=e)


@pytest.mark.parametrize("arch", ARCHS)
def test_embeddings_rounded_once(arch):
    """Under the bf16 policy f32 embeddings are cast to bf16 once, before
    the concatenation: the logits and caches ``torch.equal`` to those of
    the same embeddings cast beforehand, and within bf16's reach of the
    reference's (5e-2 of the largest |logit|)."""
    rcfg, cfg, rparams, params = _build(arch, "bf16")
    prompts, emb = _prompts(arch, 10), _embeddings(arch, seed=51)
    toks, e = torch.from_numpy(prompts).long(), torch.from_numpy(emb)
    a, ca, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ, embeddings=e)
    b, cb, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                         embeddings=e.to(torch.bfloat16))
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(ca), _leaves(cb)))
    rl, _, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                          max_seq=MAX_SEQ, embeddings=jnp.asarray(emb))
    _close(a, rl, 5e-2, f"{arch} bf16 prefill")


# ---------------------------------------------------------------- decode --

def _from_reference(rcache):
    """A reference decode cache as the port's tree of CPU tensors."""
    return {"slots": tuple(
        {"attn": {k: to_tensor(np.asarray(v)) for k, v in s["attn"].items()}}
        for s in rcache["slots"])}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_reference(arch):
    """Three decode steps from the reference's own prefill cache (with
    embeddings; so a rounding tie that two prefills broke apart does not
    count) at position S_total on: ``M.decode_step`` (a device position
    tensor, the fused step's) and ``M.decode_step_layered`` (an int)
    against a jitted reference ``decode_step``, logits within 1e-4; the
    two port steps ``torch.equal``; f32 caches within 1e-5 after."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts, emb = _prompts(arch, 11, seed=3), _embeddings(arch, seed=52)
    _, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                             max_seq=MAX_SEQ, embeddings=jnp.asarray(emb),
                             cache_dtype=jnp.float32)
    assert int(rpos) == cfg.frontend_tokens + 11
    fused, layered = _from_reference(rc), _from_reference(rc)
    step = jax.jit(lambda p, c, q, t: RM.decode_step(p, rcfg, c, q, t,
                                                     dtype=jnp.float32))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, B, 1))
    for i, tok in enumerate(toks):
        p = int(rpos) + i
        rl, rc = step(rparams, rc, jnp.asarray(p, jnp.int32),
                      jnp.asarray(tok, jnp.int32))
        t = torch.from_numpy(tok).long()
        a, _ = M.decode_step(params, cfg, fused, torch.tensor(p), t)
        b, _ = M.decode_step_layered(params, cfg, layered, p, t)
        _close(a, rl, LOGIT_TOL, f"{arch} decode at {p}")
        assert torch.equal(a, b)
    _close_caches(fused, rc, CACHE_TOL, f"{arch} decode")


# ---------------------------------------------------------------- masked --

@pytest.mark.parametrize("arch", ARCHS)
def test_masked_prefill_matches_reference(arch):
    """``attn_mask=local_global`` prefill (window 8) over S_total 24 /
    28 (ragged against the tiles of 8 and the default 64): the port's
    plain K4s against the reference's masked prefill (its kernels in
    interpret mode), logits within 1e-4 and f32 caches within 1e-5; K4m
    (``impl="dense"``) ``torch.equal`` to K4s."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts, emb = _prompts(arch, 20, seed=7), _embeddings(arch, seed=53)
    rl, rc, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                           max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                           embeddings=jnp.asarray(emb),
                           attn_mask=RAttnMaskSpec(pattern="local_global",
                                                   window=8))
    toks, e = torch.from_numpy(prompts).long(), torch.from_numpy(emb)
    out = {impl: M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                           cache_dtype=torch.float32, embeddings=e,
                           attn_mask=AttnMaskSpec(pattern="local_global",
                                                  window=8, impl=impl))
           for impl in ("sparse", "dense")}
    _close(out["sparse"][0], rl, LOGIT_TOL, f"{arch} masked prefill")
    _close_caches(out["sparse"][1], rc, CACHE_TOL, f"{arch} masked")
    assert torch.equal(out["sparse"][0], out["dense"][0])
    assert out["sparse"][2] == cfg.frontend_tokens + 20


@pytest.mark.parametrize("arch", ARCHS)
def test_kv_quant_prefill_logits_equal_wide(arch):
    """int8 KV: ``prefill(embeddings=)`` logits ``torch.equal`` to the
    wide prefill's; the cache int8 with f32 scales over S_total."""
    _, cfg, _, params = _build(arch)
    toks = torch.from_numpy(_prompts(arch, 12, seed=9)).long()
    e = torch.from_numpy(_embeddings(arch, seed=54))
    wide, _, pos = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                             embeddings=e)
    narrow, cache, qpos = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                    embeddings=e, kv_quant="int8")
    assert torch.equal(wide, narrow) and pos == qpos
    attn = cache["slots"][0]["attn"]
    assert attn["k"].dtype == torch.int8
    assert attn["k_scale"].dtype == torch.float32
    assert bool((attn["k"][:, :, :, :pos] != 0).any())
    assert bool((attn["k"][:, :, :, pos:] == 0).all())


# --------------------------------------------------------------- serving --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("two_phase", [False, True])
def test_serve_loop_matches_reference(arch, two_phase):
    """Greedy ``ServeLoop.run(prompts, gen, embeddings=)`` (fused, and
    layered) == the reference's gather ``ServeLoop.run(embeddings=)``,
    from numpy embeddings on both sides."""
    rcfg, cfg, rparams, params = _build(arch)
    prompts, emb = _prompts(arch, 12, seed=11), _embeddings(arch, seed=55)
    max_seq = cfg.frontend_tokens + 12 + 8
    want = RServeLoop(rparams, rcfg, max_seq=max_seq, dispatch="gather").run(
        jnp.asarray(prompts), 8, embeddings=jnp.asarray(emb))
    loop = ServeLoop(params, cfg, max_seq=max_seq, device="cpu",
                     two_phase=two_phase)
    got = loop.run(prompts, 8, embeddings=emb)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert loop.pos == cfg.frontend_tokens + 12
    pre = [st for st in loop.stats if st.phase == "prefill"]
    assert [st.tokens for st in pre] == [B * 12]      # the text tokens


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_fused_equals_layered(arch, temperature):
    """``ServeLoop`` fused (``model.decode_step`` on its static buffers,
    loaded at position S_total) and layered give the same tokens and the
    same first decode step logits, ``torch.equal``, with embeddings."""
    _, cfg, _, params = _build(arch)
    prompts, emb = _prompts(arch, 14, seed=12), _embeddings(arch, seed=56)
    out = {}
    for two_phase in (False, True):
        loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                         two_phase=two_phase, temperature=temperature)
        seen = []

        def keep(last, _s=loop._sample):
            seen.append(last.clone())
            return _s(last)

        loop._sample = keep
        out[two_phase] = (loop.run(prompts, 8, embeddings=emb), seen[1])
    assert np.array_equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])


@pytest.mark.parametrize("arch", ARCHS)
def test_max_seq_counts_the_frontend(arch):
    """A loop of ``max_seq`` frontend + prompt + gen - 1 serves ``gen``
    tokens (the last decode write at S_total + gen - 2); one position less
    raises on the last decode step, before it writes; a ``max_seq`` of
    the prompt alone is refused at prefill."""
    _, cfg, _, params = _build(arch)
    prompts, emb = _prompts(arch, 6, seed=13), _embeddings(arch, seed=57)
    fit = cfg.frontend_tokens + 6 + 5 - 1
    for two_phase in (False, True):
        loop = ServeLoop(params, cfg, max_seq=fit, device="cpu",
                         two_phase=two_phase)
        assert loop.run(prompts, 5, embeddings=emb).shape == (B, 5)
        short = ServeLoop(params, cfg, max_seq=fit - 1, device="cpu",
                          two_phase=two_phase)
        with pytest.raises(RuntimeError, match="overflow"):
            short.run(prompts, 5, embeddings=emb)
        with pytest.raises(ValueError, match="max_seq"):
            ServeLoop(params, cfg, max_seq=6, device="cpu",
                      two_phase=two_phase).run(prompts, 5, embeddings=emb)


# ------------------------------------------------------------ scheduling --

def _trace(arch):
    """Four text-only requests: prompts of 6-15 tokens, budgets 4-9."""
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
def test_scheduler_text_only_matches_reference_and_alone(arch, two_phase):
    """The scheduler takes no embeddings, as the reference's: these
    configs' text-only requests through ``ServeScheduler`` (fused and
    two-phase) == the reference's gather scheduler's, per request, and
    == each request alone through ``ServeLoop``."""
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
def test_cli_serves(arch, capsys):
    """``--arch <name> --smoke --device cpu``: random embeddings of the
    frontend's positions prepended, ``max_seq`` counting them; the same
    token ids under ``--two-phase on``; ``--continuous`` serves text-only
    requests."""
    out = {}
    for extra in ([], ["--two-phase", "on"]):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--gen",
                    "4", *extra])
        text = capsys.readouterr().out
        cfg = configs.get_smoke(arch)
        assert (f"after {cfg.frontend_tokens} {cfg.frontend} embedding "
                "positions") in text
        out[tuple(extra)] = text[text.index("sample generations"):]
    assert out[()] == out[("--two-phase", "on")]
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--continuous", "--requests", "3", "--slots", "2"])
    assert "tok/s" in capsys.readouterr().out
