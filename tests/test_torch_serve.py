"""Port vs reference: the serving slice end to end, on the CPU.

The port's two-phase ``ServeLoop(dispatch="bcsr", device="cpu")`` (route on
the host, execute through the SpMM wrapper's plain path) is held against the
reference ``ServeLoop`` with gather dispatch (fused jit decode), which by the
reference's contract computes the same tokens.  Weights come from the
reference's ``init_params`` through ``interop.params_from_jax``; prompts
from a numpy seed.  Greedy tokens must be equal and prefill logits within
1e-4 (f32 policy; the KV cache is bf16 in both, as in serving).
"""
import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.core.masks import AttnMaskSpec as RAttnMaskSpec
from repro.launch.serve import ServeLoop as RServeLoop
from repro.models import model as RM
from repro.models.config import ArchConfig as RArchConfig

import repro_torch
from repro_torch import configs
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]

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
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
    return rcfg, cfg


# the two-phase MoE stage: route_moe, then execute_moe with the bcsr stream
_two_phase = functools.partial(moe.apply_moe, dispatch="bcsr")


@pytest.fixture(scope="module", params=["tiny", "scout-smoke"])
def model(request):
    rcfg, cfg = _cfgs(request.param)
    rparams = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (B, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


def test_bcsr_serve_loop_matches_reference(model):
    rcfg, cfg, rparams, params, prompts = model
    want = RServeLoop(rparams, rcfg, max_seq=MAX_SEQ).run(
        jnp.asarray(prompts), GEN)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="bcsr",
                     device="cpu")
    assert loop.two_phase
    got = loop.run(prompts, GEN)
    np.testing.assert_array_equal(got, want)
    s = loop.summary()
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    assert s["route"]["calls"] == s["execute"]["calls"] == GEN * n_moe
    assert s["decode"]["calls"] == GEN - 1 and s["decode"]["tok_per_s"] > 0
    assert s["prefill"]["calls"] == 1
    assert s["stream"]["nnzb_stream_mean"] >= s["stream"]["nnzb_routed_mean"]
    # the port's own law: gather dispatch gives the same tokens
    gather = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="gather",
                       device="cpu")
    assert not gather.two_phase
    np.testing.assert_array_equal(gather.run(prompts, GEN), got)


def test_prefill_logits_and_decode_match_reference(model):
    rcfg, cfg, rparams, params, prompts = model
    rlogits, rcache, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                                       max_seq=MAX_SEQ)
    logits, cache, pos = M.prefill_layered(
        params, torch.from_numpy(prompts).long(), cfg, max_seq=MAX_SEQ,
        moe_fn=_two_phase)
    assert pos == int(rpos)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               atol=1e-4, rtol=0)
    for slot, rslot in zip(cache["slots"], rcache["slots"]):
        assert slot["attn"]["k"].dtype == torch.bfloat16
        if "moe" in rslot:
            np.testing.assert_array_equal(slot["moe"].numpy(),
                                          np.asarray(rslot["moe"]))
    tok = np.argmax(np.asarray(rlogits)[:, -1, :cfg.vocab_size], -1)[:, None]
    rl, _ = RM.decode_step(rparams, rcfg, rcache, rpos,
                           jnp.asarray(tok, jnp.int32))
    got, same = M.decode_step_layered(params, cfg, cache, pos,
                                      torch.from_numpy(tok), moe_fn=_two_phase)
    assert same is cache            # updated in place
    np.testing.assert_allclose(got.numpy(), np.asarray(rl), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def scout_masked():
    """scout-SMOKE (f32) weights and B=4 prompts of 32 tokens: the masked
    serving comparison (the reference's bcsr path needs a batch that is a
    multiple of its 4 virtual devices; its gather path is the oracle)."""
    rcfg, cfg = _cfgs("scout-smoke")
    rparams = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                (4, 32)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


MASK_KW = dict(local=True, pattern="local_global", window=8, bq=8, bk=8)
MASK_GEN = 6


@pytest.mark.parametrize("impl", ["sparse", "dense"])
def test_masked_serve_loop_matches_reference(scout_masked, impl):
    """Masked prefill serving: the port's bcsr ServeLoop gives the
    reference gather ServeLoop's greedy tokens, and within the port the
    sparse walk gives the dense-masked tokens."""
    rcfg, cfg, rparams, params, prompts = scout_masked
    max_seq = prompts.shape[1] + MASK_GEN
    want = RServeLoop(rparams, rcfg, max_seq=max_seq, dispatch="gather",
                      attn_mask=RAttnMaskSpec(**MASK_KW, impl=impl)).run(
        jnp.asarray(prompts), MASK_GEN)
    toks = {}
    for i in ("sparse", "dense"):
        loop = ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr",
                         attn_mask=AttnMaskSpec(**MASK_KW, impl=i),
                         device="cpu")
        toks[i] = loop.run(prompts, MASK_GEN)
        assert loop.summary()["timing"]["attention_ref_fallbacks"] == 0
    np.testing.assert_array_equal(toks[impl], want)
    np.testing.assert_array_equal(toks["sparse"], toks["dense"])
    # the mask is a real test: unmasked serving gives other tokens
    plain = ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr",
                      device="cpu").run(prompts, MASK_GEN)
    assert not np.array_equal(plain, toks[impl])


def test_masked_prefill_kernel_impl_and_fallbacks(scout_masked):
    """prefill_layered(impl="kernel") runs K3 (plain on the CPU) at every
    layer and agrees with the chunked prefill to the formulations'
    difference; attn_mask impl="ref" is counted in summary()["timing"]."""
    rcfg, cfg, rparams, params, prompts = scout_masked
    toks = torch.from_numpy(prompts).long()
    kern, kcache, _ = M.prefill_layered(params, toks, cfg, max_seq=40,
                                        moe_fn=_two_phase, impl="kernel")
    chunk, ccache, _ = M.prefill_layered(params, toks, cfg, max_seq=40,
                                         moe_fn=_two_phase)
    np.testing.assert_allclose(kern.numpy(), chunk.numpy(), atol=1e-4,
                               rtol=0)
    for a, b in zip(kcache["slots"], ccache["slots"]):
        assert torch.equal(a["attn"]["k"], b["attn"]["k"])
    loop = ServeLoop(params, cfg, max_seq=prompts.shape[1] + 3,
                     dispatch="bcsr", device="cpu",
                     attn_mask=AttnMaskSpec(**MASK_KW, impl="ref"))
    before = fops.fallback_count()
    loop.run(prompts, 3)
    n = loop.summary()["timing"]["attention_ref_fallbacks"]
    assert n == cfg.n_repeats == fops.fallback_count() - before
    loop.run(prompts, 3)           # counted from the run's own baseline
    assert loop.summary()["timing"]["attention_ref_fallbacks"] == n


def test_init_params_layout_matches_reference():
    """The port's param tree has the reference's structure and shapes, with
    matmul weights in the compute dtype and norms/routers in f32."""
    rcfg, _ = _cfgs("tiny")
    want = jax.eval_shape(lambda k: RM.init_params(k, rcfg),
                          jax.random.PRNGKey(0))
    cfg = dataclasses.replace(ArchConfig(**TINY_KW), policy="bf16")
    got = M.init_params(cfg, seed=0, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_w] == \
        [jax.tree_util.keystr(k) for k, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape), path
        leaf = path[-1].key
        want_dt = torch.float32 if leaf in ("scale", "router") \
            else torch.bfloat16
        assert g.dtype == want_dt, path
    again = M.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["blocks"][1]["ffn"]["router"],
                       got["blocks"][1]["ffn"]["router"])
    want_c = jax.eval_shape(lambda: RM.init_cache(rcfg, B, MAX_SEQ))
    got_c = M.init_cache(cfg, B, MAX_SEQ, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want_c)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got_c)[0]
    assert len(flat_w) == len(flat_g)
    for (path, w), (_, g) in zip(flat_w, flat_g):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype) == "torch." + str(w.dtype), path


def test_interop_bf16_crossing():
    a = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32), jnp.bfloat16)
    t = to_tensor(np.asarray(a))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(a, np.float32))
    cfg = dataclasses.replace(ArchConfig(**TINY_KW), policy="bf16")
    p = params_from_jax({"router": np.ones((4, 2), np.float32),
                         "w": np.ones((4, 2), np.float32),
                         "ln": {"scale": np.ones(4, np.float32)}},
                        cfg, device="cpu")
    assert (p["router"].dtype, p["w"].dtype, p["ln"]["scale"].dtype) == \
        (torch.float32, torch.bfloat16, torch.float32)


def test_sampling_overflow_and_device_guards():
    rcfg, cfg = _cfgs("tiny")
    params = M.init_params(cfg, seed=1, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, PROMPT))
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch="bcsr",
                     temperature=0.8, device="cpu")
    first = loop.run(prompts, GEN)
    np.testing.assert_array_equal(loop.run(prompts, GEN), first)  # reseeded
    assert first.shape == (B, GEN) and (first < cfg.vocab_size).all()
    with pytest.raises(RuntimeError):
        loop.decode(MAX_SEQ)        # writes past the KV cache
    with pytest.raises(ValueError):
        M.decode_step_layered(params, cfg, loop.cache, MAX_SEQ,
                              torch.zeros((B, 1), dtype=torch.long))
    with pytest.raises(KeyError, match="not yet ported"):
        configs.get_config("llama4-behemoth")
    with pytest.raises(NotImplementedError, match="frontend"):
        M.init_params(dataclasses.replace(cfg, frontend="video"),
                      device="cpu")
    if torch.cuda.is_available():
        assert repro_torch.resolve_device("cuda").type == "cuda"
    else:                           # entry points never fall back silently
        for call in (lambda: M.init_params(cfg),
                     lambda: ServeLoop(params, cfg, max_seq=MAX_SEQ),
                     lambda: serve.main(["--arch", "llama4-scout-17b-a16e",
                                         "--smoke"])):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_cli_main_on_cpu(capsys):
    args = ["--arch", "llama4-scout-17b-a16e", "--smoke", "--batch", "2",
            "--prompt-len", "8", "--gen", "4", "--device", "cpu"]
    bcsr = serve.main(args + ["--dispatch", "bcsr"])
    out = capsys.readouterr().out
    assert "[two-phase]" in out and "stream:" in out
    np.testing.assert_array_equal(serve.main(args + ["--dispatch", "gather"]),
                                  bcsr)
    masked = serve.main(args + ["--attn-mask", "local_global",
                                "--attn-mask-impl", "sparse"])
    assert "attn mask: local_global (sparse), 0 oracle fallbacks" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(
        serve.main(args + ["--attn-mask", "local_global",
                           "--attn-mask-impl", "dense"]), masked)


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    reference package."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("core/masks.py", "kernels/flash_attention/kernel.py",
                "kernels/flash_attention/ops.py",
                "kernels/flash_attention/ref.py", "kernels/wkv/kernel.py",
                "kernels/wkv/ops.py", "kernels/wkv/ref.py",
                "models/rwkv6.py", "configs/rwkv6_7b.py"):
        assert "src/repro_torch/" + mod in names
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (f, n)
