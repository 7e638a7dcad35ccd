"""Port vs reference: RWKV-6 serving (rwkv6-7b SMOKE) on the CPU.

Weights come from the reference's ``init_params`` through
``interop.params_from_jax``, prompts and activations from numpy seeds.  The
port's prefill runs the chunked WKV through ``ops.wkv_state`` (the plain
version on the CPU), its decode the one-step recurrence.

Tolerances, f32 policy: a mixer half within 2e-5 of its largest |value|
(the chunked WKV's bound, see tests/test_torch_wkv.py); logits within 1e-4
(as the other serving tests); a bf16 cache leaf within one bf16 ulp of the
reference's (both round an f32 value that differs in its last bits, which
can cross a rounding boundary).  Under the bf16 policy the frameworks round
bf16 activations at other points, so only the f32 state's dtype and its
values within 2e-2 of their largest |value| are checked.
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
from repro.launch.serve import ServeLoop as RServeLoop
from repro.models import model as RM
from repro.models import rwkv6 as R6

from repro_torch import configs
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import model as M
from repro_torch.models import rwkv6

torch.set_num_threads(2)
ARCH = "rwkv6-7b"
B, PROMPT, GEN = 2, 8, 6
MAX_SEQ = PROMPT + GEN
BF16_ULP = 2.0 ** -7           # one bf16 ulp, relative to the value


def _cfgs(policy):
    rcfg = dataclasses.replace(r_get_smoke(ARCH), policy=policy)
    cfg = dataclasses.replace(configs.get_smoke(ARCH), policy=policy)
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _build(policy):
    rcfg, cfg = _cfgs(policy)
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


@pytest.fixture(scope="module", params=["f32", "bf16"])
def model(request):
    return _build(request.param)


@pytest.fixture(scope="module")
def f32_model():
    return _build("f32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


def _bf16_close(got, want, what):
    """Within one bf16 ulp of each value, plus the f32 bound of the value
    that was rounded (2e-5 of the largest |value|)."""
    got, want = _np(got), _np(want)
    tol = BF16_ULP * np.abs(want) + 2e-5 * np.abs(want).max()
    assert (np.abs(got - want) <= tol).all(), what


def test_configs_equal_reference():
    for get, rget in ((configs.get_config, r_get_config),
                      (configs.get_smoke, r_get_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(rget(ARCH))
    assert ARCH in configs.ARCH_NAMES


def test_init_params_and_cache_layouts(model):
    rcfg, cfg, rparams, params, _ = model
    mine = M.init_params(cfg, seed=0, device="cpu")
    converted = jax.tree_util.tree_flatten_with_path(rparams)[0]
    flat = {jax.tree_util.keystr(k): v for k, v in converted}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{prefix}['{k}']")
        elif isinstance(tree, tuple):
            for i, v in enumerate(tree):
                yield from walk(v, f"{prefix}[{i}]")
        else:
            yield prefix, tree

    ours = dict(walk(mine))
    conv = dict(walk(params))
    assert set(ours) == set(conv) == set(flat)
    for key, t in ours.items():
        assert tuple(t.shape) == tuple(flat[key].shape), key
        assert t.dtype == conv[key].dtype, key
    f32 = {k for k, t in ours.items() if t.dtype == torch.float32}
    assert any("decay_lora_a" in k for k in f32)
    assert any("bonus_u" in k for k in f32)

    rcache = RM.init_cache(rcfg, B, MAX_SEQ)
    cache = M.init_cache(cfg, B, MAX_SEQ, device="cpu")
    rflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(rcache)[0]}
    cflat = dict(walk(cache))
    assert set(rflat) == set(cflat)
    for key, t in cflat.items():
        assert tuple(t.shape) == tuple(rflat[key].shape), key
        assert str(t.dtype)[6:] == str(rflat[key].dtype), key
        assert not t.any()


def test_time_and_channel_mix_prefill_and_decode(f32_model):
    rcfg, cfg, rparams, params, _ = f32_model
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"][0]["mixer"])
    p = M._take(params["blocks"][0], 0)["mixer"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, PROMPT, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    rt, rct = R6.apply_rwkv_time(rp, jnp.asarray(x), rcfg, collect=True)
    t, ct = rwkv6.apply_rwkv_time(p, torch.from_numpy(x), cfg, collect=True)
    _close(t, rt, 2e-5, "time mix, prefill")
    _close(ct["wkv"], rct["wkv"], 2e-5, "wkv state, prefill")
    assert torch.equal(ct["shift_t"], torch.from_numpy(x[:, -1:]))
    rt1, rct1 = R6.apply_rwkv_time(rp, jnp.asarray(x1), rcfg, cache=rct)
    t1, ct1 = rwkv6.apply_rwkv_time(p, torch.from_numpy(x1), cfg, cache=ct)
    _close(t1, rt1, 2e-5, "time mix, decode")
    _close(ct1["wkv"], rct1["wkv"], 2e-5, "wkv state, decode")

    rc, rcc = R6.apply_rwkv_channel(rp, jnp.asarray(x), rcfg, collect=True)
    c, cc = rwkv6.apply_rwkv_channel(p, torch.from_numpy(x), cfg,
                                     collect=True)
    _close(c, rc, 1e-5, "channel mix, prefill")
    rc1, _ = R6.apply_rwkv_channel(rp, jnp.asarray(x1), rcfg, cache=rcc)
    c1, cc1 = rwkv6.apply_rwkv_channel(p, torch.from_numpy(x1), cfg,
                                       cache=cc)
    _close(c1, rc1, 1e-5, "channel mix, decode")
    assert torch.equal(cc1["shift_c"], torch.from_numpy(x1))
    assert rwkv6.apply_rwkv_channel(p, torch.from_numpy(x), cfg)[1] is None


def test_prefill_logits_and_cache(model):
    """The reference's cache rule: under f32 every f32 leaf, the WKV state
    included, is rounded to the bf16 cache; under bf16 the state stays
    f32."""
    rcfg, cfg, rparams, params, prompts = model
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ)
    l, c, pos = M.prefill_layered(params, torch.from_numpy(prompts).long(),
                                  cfg, max_seq=MAX_SEQ)
    assert pos == int(rpos) == PROMPT
    assert tuple(l.shape) == (B, 1, cfg.padded_vocab)
    for key in ("wkv", "shift_t", "shift_c"):
        got, want = c["slots"][0][key], rc["slots"][0][key]
        assert str(got.dtype)[6:] == str(want.dtype), key
        assert tuple(got.shape) == tuple(want.shape), key
    if cfg.policy == "f32":
        assert c["slots"][0]["wkv"].dtype == torch.bfloat16
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-4)
        for key in ("wkv", "shift_t", "shift_c"):
            _bf16_close(c["slots"][0][key], rc["slots"][0][key], key)
    else:
        assert c["slots"][0]["wkv"].dtype == torch.float32
        _close(c["slots"][0]["wkv"], rc["slots"][0]["wkv"], 2e-2,
               "bf16 policy: f32 state")


def test_decode_steps_match_reference(f32_model):
    rcfg, cfg, rparams, params, prompts = f32_model
    _, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                             max_seq=MAX_SEQ)
    # decode from the reference's own prefill cache (bf16 leaves), so a
    # bf16 rounding tie that prefill broke the other way does not count
    c = {"slots": tuple({k: to_tensor(jax.device_get(v)) for k, v in
                         slot.items()} for slot in rc["slots"])}
    pos = int(rpos)
    step = jax.jit(lambda p, cc, q, tok: RM.decode_step(p, rcfg, cc, q, tok))
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, B, 1))
    for i, tok in enumerate(toks):
        rl, rc = step(rparams, rc, jnp.asarray(int(rpos) + i, jnp.int32),
                      jnp.asarray(tok, jnp.int32))
        l, c2 = M.decode_step_layered(params, cfg, c, pos + i,
                                      torch.from_numpy(tok).long())
        assert c2 is c
        np.testing.assert_allclose(l.numpy(), np.asarray(rl), atol=1e-4)
    for key in ("wkv", "shift_t", "shift_c"):
        # decode returns the state in f32, as the reference's step does
        assert c["slots"][0][key].dtype == torch.float32
        assert str(rc["slots"][0][key].dtype) == "float32"
        _close(c["slots"][0][key], rc["slots"][0][key], 2e-5, key)


def test_serve_loop_tokens_match_reference(f32_model):
    rcfg, cfg, rparams, params, prompts = f32_model
    want = RServeLoop(rparams, rcfg, max_seq=MAX_SEQ).run(
        jnp.asarray(prompts), GEN)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    got = loop.run(prompts, GEN)
    assert not loop.two_phase
    np.testing.assert_array_equal(got, np.asarray(want))
    s = loop.summary()
    assert s["prefill"]["calls"] == 1 and s["decode"]["calls"] == GEN - 1


def test_cache_without_attention_never_overflows(f32_model):
    _, cfg, _, params, prompts = f32_model
    cache = M.init_cache(cfg, B, MAX_SEQ, device="cpu")
    assert M.cache_capacity(cache, cfg) is None
    M.check_cache_fits(cache, 10 ** 6, cfg)     # no attention slot: no bound
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    loop.run(prompts, 2)
    with pytest.raises(RuntimeError, match="max_seq"):
        loop.decode(MAX_SEQ)                    # the loop's own limit holds


def test_cli_serves_rwkv_on_cpu(capsys):
    args = ["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len", "8",
            "--gen", "4", "--device", "cpu"]
    gen = serve.main(args)
    out = capsys.readouterr().out
    assert gen.shape == (2, 4) and "decode:" in out
    assert "[two-phase]" not in out
    np.testing.assert_array_equal(serve.main(args), gen)
