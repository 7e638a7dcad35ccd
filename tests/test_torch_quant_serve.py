"""Port vs reference: quantized experts and quantized KV caches through
both serving drivers (``quantize_experts=`` / ``kv_quant=``), on the CPU.

The reference's arithmetic ("Narrow-precision contract" in
``tests/README.md``): the expert weights are BlockQuant'ed once (one f32
scale per expert and output channel, ``moe.quantize_model_experts``) and
dequantized at each expert product; the attention cache is stored per
position as narrow values and f32 scales and dequantized before decode
attention.  Held here, on TINY (the reference's serving test model) and
llama4-scout SMOKE, f32 policy, weights from the reference's
``init_params`` through ``interop.params_from_jax``, prompts from numpy
seeds:

* the quantized weights: bitwise the reference's ``QuantTensor`` values
  and scales in int8, fp8 e4m3 and fp8 e5m2; the refusal without a MoE
  slot; ``model._take`` slicing a ``QuantTensor``; the expert FFN on
  quantized weights ``torch.equal`` to it on the dequantized ones, gather
  and bcsr;
* the quantized cache: prefill logits ``torch.equal`` to the wide run's
  (quantization touches only the emitted cache), the collected values and
  scales bitwise the reference's quantizer applied to the wide cache, and
  within one quantization step of the reference's own quantized prefill;
  ``init_cache(kv_quant=)``'s leaves; the first decode step within 0.2
  relative error of wide (the reference's bound); f32 scales kept under
  the f32 policy with a bf16 cache;
* greedy tokens: int8 experts + int8 cache give the wide tokens and the
  reference's gather ``ServeLoop``'s quantized tokens, two-phase and
  fused; the quantized scheduler's tokens per request equal the quantized
  static loop's and the reference's, fused == layered; the CLI flags.

Tokens are compared exactly; each tolerance is stated where it is used.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.core import precision as rprecision
from repro.launch.serve import ServeLoop as RServeLoop
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.models.config import ArchConfig as RArchConfig

from repro_torch import configs
from repro_torch.core.precision import QUANT_DTYPES, QuantTensor
from repro_torch.interop import params_from_jax, quant_tensor_from_jax
from repro_torch.interop import to_tensor
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)

QUANT = ("fp8_e4m3", "fp8_e5m2", "int8")
TINY_KW = dict(
    name="tiny-quant", family="moe", d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"), n_repeats=2,
    head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
MAX_SEQ, PROMPT, GEN = 14, 8, 6


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
    rparams = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return rcfg, cfg, rparams, params, prompts


@pytest.fixture(scope="module", params=["tiny", "scout-smoke"])
def model(request):
    return _build(request.param)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A narrow tensor's bytes (torch.equal of fp8 compares as bytes)."""
    return t.view(torch.uint8) if t.element_size() == 1 else t


def _moe_slot(cfg):
    return cfg.block_unit.index("attn+moe")


# ------------------------------------------------------ quantized experts --

@pytest.mark.parametrize("dtype", QUANT)
def test_quantize_model_experts_bitwise_reference(model, dtype):
    """Every expert leaf of every MoE slot: the port's values and scales
    are the reference's, bit for bit; the axis is -2; the router and the
    shared expert are the params' own tensors (untouched)."""
    rcfg, cfg, rparams, params, _ = model
    want = rmoe.quantize_model_experts(rparams, dtype)
    got = moe.quantize_model_experts(params, dtype)
    slot = _moe_slot(cfg)
    for name, qt in got["blocks"][slot]["ffn"]["experts"].items():
        ref = quant_tensor_from_jax(jax.device_get(
            want["blocks"][slot]["ffn"]["experts"][name]), device="cpu")
        assert isinstance(qt, QuantTensor) and qt.axis == -2 == ref.axis
        assert qt.values.dtype == ref.values.dtype
        assert torch.equal(_bytes(qt.values), _bytes(ref.values)), name
        assert torch.equal(qt.scales, ref.scales), name
    ffn, qffn = params["blocks"][slot]["ffn"], got["blocks"][slot]["ffn"]
    assert qffn["router"] is ffn["router"]
    assert qffn["shared"] is ffn["shared"]
    assert params["blocks"][slot]["ffn"]["experts"]["w_up"].dtype \
        == torch.float32                                  # input unchanged


def test_quantize_model_experts_needs_a_moe_slot():
    """Without an attn+moe slot (rwkv6-7b SMOKE, or TINY's dense slot
    alone) it raises, as the reference does."""
    cfg = configs.get_smoke("rwkv6-7b")
    with pytest.raises(ValueError, match="experts"):
        moe.quantize_model_experts(M.init_params(cfg, device="cpu"), "int8")
    _, _, _, params, _ = _build("tiny")
    with pytest.raises(ValueError, match="experts"):
        moe.quantize_model_experts({"blocks": (params["blocks"][0],)},
                                   "int8")
    with pytest.raises(ValueError, match="experts"):
        moe.quantize_expert_weights({"router": None}, "int8")


def test_take_slices_a_quant_tensor():
    """``model._take`` gives layer i of a stacked ``QuantTensor``: values
    and scales sliced, the negative axis kept, dequantizing to layer i of
    the whole stack's dequantized weight."""
    _, cfg, _, params, _ = _build("scout-smoke")
    q = moe.quantize_model_experts(params, "int8")
    stacked = q["blocks"][0]["ffn"]["experts"]["w_gate"]
    for i in range(cfg.n_repeats):
        layer = M._take(q["blocks"][0], i)["ffn"]["experts"]["w_gate"]
        assert isinstance(layer, QuantTensor) and layer.axis == -2
        assert torch.equal(layer.values, stacked.values[i])
        assert torch.equal(layer.scales, stacked.scales[i])
        assert torch.equal(layer.dequantize(torch.float32),
                           stacked.dequantize(torch.float32)[i])


@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
@pytest.mark.parametrize("dtype", QUANT)
def test_quantized_expert_ffn_equals_dequantized(model, dispatch, dtype):
    """``apply_moe`` on quantized experts ``torch.equal`` to it on the
    host-dequantized f32 weights (``_wcast`` dequantizes to the compute
    dtype as ``QuantTensor.dequantize`` does), both backends."""
    _, cfg, _, params, _ = model
    slot = _moe_slot(cfg)
    qffn = M._take(moe.quantize_model_experts(params, dtype)["blocks"][slot],
                   0)["ffn"]
    dffn = dict(qffn, experts={k: w.dequantize(torch.float32)
                               for k, w in qffn["experts"].items()})
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    out_q, _ = moe.apply_moe(qffn, x, cfg, dispatch=dispatch)
    out_d, _ = moe.apply_moe(dffn, x, cfg, dispatch=dispatch)
    assert torch.equal(out_q, out_d)


# --------------------------------------------------------- quantized KV --

@pytest.mark.parametrize("dtype", QUANT)
@pytest.mark.parametrize("fused", [True, False])
def test_kv_quant_prefill_logits_equal_wide(model, dtype, fused):
    """kv_quant touches only the emitted cache: ``prefill`` and
    ``prefill_layered`` logits ``torch.equal`` to the wide run's; every
    attention leaf is narrow values + f32 scales over head_dim, bitwise the
    reference's ``quantize_rows`` of the wide cache."""
    _, cfg, _, params, prompts = model
    fn = M.prefill if fused else M.prefill_layered
    lg_w, cw, pos_w = fn(params, torch.from_numpy(prompts), cfg,
                         max_seq=MAX_SEQ, cache_dtype=torch.float32)
    lg_q, cq, pos_q = fn(params, torch.from_numpy(prompts), cfg,
                         max_seq=MAX_SEQ, cache_dtype=torch.float32,
                         kv_quant=dtype)
    assert torch.equal(lg_q, lg_w) and pos_q == pos_w
    for wide, quant in zip(cw["slots"], cq["slots"]):
        leaf = quant["attn"]
        assert set(leaf) == {"k", "k_scale", "v", "v_scale"}
        for n in ("k", "v"):
            assert leaf[n].dtype == QUANT_DTYPES[dtype]
            assert leaf[n + "_scale"].dtype == torch.float32
            assert leaf[n + "_scale"].shape == wide["attn"][n].shape[:-1]
            rq, rs = rprecision.quantize_rows(
                jnp.asarray(wide["attn"][n].numpy()), dtype)
            assert torch.equal(_bytes(leaf[n]), _bytes(to_tensor(
                jax.device_get(rq))))
            assert torch.equal(leaf[n + "_scale"],
                               torch.from_numpy(np.array(rs)))
        if "moe" in wide:
            assert torch.equal(quant["moe"], wide["moe"])


def test_kv_quant_cache_near_the_reference_prefill(model):
    """The port's int8 cache against the reference's own quantized
    prefill (each framework's projections round their last bits apart):
    scales within 1e-5 relative, dequantized values within one
    quantization step (the scale) of the reference's."""
    rcfg, cfg, rparams, params, prompts = model
    _, rc, _ = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                          max_seq=MAX_SEQ, cache_dtype=jnp.float32,
                          kv_quant="int8")
    _, cq, _ = M.prefill(params, torch.from_numpy(prompts), cfg,
                         max_seq=MAX_SEQ, cache_dtype=torch.float32,
                         kv_quant="int8")
    for rslot, slot in zip(rc["slots"], cq["slots"]):
        for n in ("k", "v"):
            rs = np.asarray(rslot["attn"][n + "_scale"], np.float64)
            s = slot["attn"][n + "_scale"].numpy().astype(np.float64)
            assert np.abs(s - rs).max() <= 1e-5 * rs.max()
            rd = np.asarray(rslot["attn"][n], np.float64) * rs[..., None]
            d = slot["attn"][n].numpy().astype(np.float64) * s[..., None]
            assert (np.abs(d - rd) <= rs[..., None] * (1 + 1e-5)).all()


def test_init_cache_kv_quant_leaves():
    """``init_cache(kv_quant=)``: narrow zero K / V and f32 scales of ones
    (the all-zero convention) in the reference's layout."""
    rcfg, cfg, _, _, _ = _build("tiny")
    for dtype in QUANT:
        rcache = RM.init_cache(rcfg, 3, MAX_SEQ, kv_quant=dtype)
        cache = M.init_cache(cfg, 3, MAX_SEQ, device="cpu", kv_quant=dtype)
        for rslot, slot in zip(rcache["slots"], cache["slots"]):
            assert set(slot["attn"]) == set(rslot["attn"])
            for n, t in slot["attn"].items():
                r = rslot["attn"][n]
                assert tuple(t.shape) == tuple(r.shape), n
                scale = n.endswith("_scale")
                assert t.dtype == (torch.float32 if scale
                                   else QUANT_DTYPES[dtype]), n
                want = 1.0 if scale else 0.0
                assert bool((t.float() == want).all()), n


@pytest.mark.parametrize("dtype", QUANT)
def test_kv_quant_first_decode_step_within_bound(model, dtype):
    """The first decode step's logits from a quantized cache (int8
    experts too) within 0.2 relative error (largest |difference| over the
    largest |logit|) of the wide step's, the reference's bound; at a
    scalar and at a per-row position alike."""
    _, cfg, _, params, prompts = model

    def first_step(params, kv_quant, pos_vector):
        lg, cache, pos = M.prefill(params, torch.from_numpy(prompts), cfg,
                                   max_seq=MAX_SEQ, cache_dtype=torch.float32,
                                   kv_quant=kv_quant)
        tok = lg[:, -1:, :cfg.vocab_size].argmax(-1)
        p = np.full(prompts.shape[0], pos) if pos_vector else pos
        out, _ = M.decode_step_layered(params, cfg, cache, p, tok)
        return out

    for pos_vector in (False, True):
        ref = first_step(params, None, pos_vector)
        for p in (params, moe.quantize_model_experts(params, "int8")):
            got = first_step(p, dtype, pos_vector)
            rel = (got - ref).abs().max() / ref.abs().max().clamp(min=1e-6)
            assert rel < 0.2, f"{dtype}: first decode step off by {rel}"


def test_scales_stay_f32_under_the_f32_policy():
    """Under the f32 policy the compute dtype is f32, so the wide leaves
    become the bf16 ``cache_dtype``; the quantized cache's f32 scales do
    not (the reference's ``_cache_to_dtype`` rule)."""
    _, cfg, _, params, prompts = _build("tiny")
    _, cw, _ = M.prefill(params, torch.from_numpy(prompts), cfg,
                         max_seq=MAX_SEQ)
    _, cq, _ = M.prefill(params, torch.from_numpy(prompts), cfg,
                         max_seq=MAX_SEQ, kv_quant="int8")
    assert cw["slots"][0]["attn"]["k"].dtype == torch.bfloat16
    for slot in cq["slots"]:
        assert slot["attn"]["k"].dtype == torch.int8
        assert slot["attn"]["k_scale"].dtype == torch.float32
        assert slot["attn"]["v_scale"].dtype == torch.float32
    tree = {"k": torch.zeros(2), "k_scale": torch.ones(2),
            "v_scale": torch.ones(2), "v": torch.zeros(2)}
    out = M._cache_to_dtype(tree, torch.float32, torch.bfloat16)
    assert out["k"].dtype == out["v"].dtype == torch.bfloat16
    assert out["k_scale"] is tree["k_scale"] \
        and out["v_scale"] is tree["v_scale"]


# -------------------------------------------------------------- serving --

@functools.lru_cache(maxsize=None)
def _reference_loop(name, quantized):
    """The reference's gather ``ServeLoop`` (its bcsr serving is red on
    this jax) on the prompts, wide or int8 experts + int8 cache."""
    rcfg, _, rparams, _, prompts = _build(name)
    kw = dict(quantize_experts="int8", kv_quant="int8") if quantized else {}
    return np.asarray(RServeLoop(rparams, rcfg, max_seq=MAX_SEQ,
                                 dispatch="gather", **kw).run(
        jnp.asarray(prompts), GEN))


@pytest.mark.parametrize("dispatch,two_phase", [("bcsr", None),
                                                ("gather", None),
                                                ("bcsr", False),
                                                ("gather", True)])
def test_int8_greedy_tokens_equal_wide_and_reference(model, dispatch,
                                                     two_phase):
    """int8 experts + int8 cache: the greedy tokens of the port's
    ``ServeLoop`` (two-phase bcsr, fused gather, fused bcsr, layered
    gather) equal the wide tokens and the reference's gather loop's, wide
    and quantized (the reference's ``test_kv_quant_int8_greedy_tokens_
    stable``)."""
    rcfg, cfg, _, params, prompts = model
    name = "tiny" if cfg.name == "tiny-quant" else "scout-smoke"
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                     two_phase=two_phase, quantize_experts="int8",
                     kv_quant="int8", device="cpu")
    got = loop.run(prompts, GEN)
    assert loop.kv_quant == "int8" and loop.quantize_experts == "int8"
    assert isinstance(M._take(loop.params["blocks"][_moe_slot(cfg)], 0)[
        "ffn"]["experts"]["w_up"], QuantTensor)
    assert "k_scale" in loop.cache["slots"][0]["attn"]
    np.testing.assert_array_equal(got, _reference_loop(name, True))
    np.testing.assert_array_equal(got, _reference_loop(name, False))
    wide = ServeLoop(params, cfg, max_seq=MAX_SEQ, dispatch=dispatch,
                     two_phase=two_phase, device="cpu").run(prompts, GEN)
    np.testing.assert_array_equal(got, wide)


@pytest.mark.parametrize("two_phase", [False, True])
def test_quantized_scheduler_matches_static_loop(model, two_phase):
    """A quantized slot pool (narrow values and scales scattered per row):
    each request's tokens equal the quantized static loop's and the
    reference's quantized gather scheduler's; fused == layered."""
    rcfg, cfg, rparams, params, prompts = model
    kw = dict(quantize_experts="int8", kv_quant="int8")
    sched = ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                           two_phase=two_phase, device="cpu", **kw)
    assert sched.cache["slots"][0]["attn"]["k"].dtype == torch.int8
    assert sched.cache["slots"][0]["attn"]["k_scale"].dtype == torch.float32
    uids = [sched.submit(p, GEN).uid for p in prompts]
    out = sched.run()
    seq = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                    **kw).run(prompts, GEN)
    rs = RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ, max_slots=2,
                         dispatch="gather", **kw)
    ruids = [rs.submit(np.asarray(p), GEN).uid for p in prompts]
    rout = rs.run()
    for i, (u, ru) in enumerate(zip(uids, ruids)):
        np.testing.assert_array_equal(out[u], seq[i])
        np.testing.assert_array_equal(out[u], np.asarray(rout[ru]))


def test_quantized_fused_step_restores_live_rows():
    """The fused scheduler's capture guard (``serve._rows_kept``) carries
    the scale leaves: a quantized pool with residents is ``torch.equal``
    before and after a bucket's warm-up steps."""
    _, cfg, _, params, prompts = _build("scout-smoke")
    sched = ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=4,
                           two_phase=False, kv_quant="int8", device="cpu")
    for p in prompts:
        sched.submit(p, GEN)
    sched.admit()
    before = serve._clone_leaves(sched.cache)
    sched._fused_decode(2)
    flat = lambda t: (t["slots"][0]["attn"], t["slots"][0]["moe"])  # noqa
    for a, b in zip(flat(before), flat(sched.cache)):
        if isinstance(a, dict):
            assert all(torch.equal(_bytes(a[k]), _bytes(b[k])) for k in a)
        else:
            assert torch.equal(a, b)


def test_driver_refuses_an_unknown_quant_name():
    _, cfg, _, params, _ = _build("tiny")
    for kw in ({"kv_quant": "int4"}, {"quantize_experts": "bf16"}):
        with pytest.raises(ValueError, match="choose from"):
            ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu", **kw)


@pytest.mark.parametrize("extra", [[], ["--continuous", "--two-phase", "off"],
                                   ["--two-phase", "off"]])
def test_cli_quantized_flags(monkeypatch, capsys, extra):
    """``--quantize-experts int8 --kv-quant int8 --device cpu`` serves (the
    static loop two-phase and fused, and the scheduler): the driver is made
    with both names, its experts are quantized and its cache holds
    scales, and the tokens are valid ids of the asked shape."""
    made = []
    init = serve._ServeBase.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(serve._ServeBase, "__init__", spy)
    out = serve.main(["--arch", "llama4-scout-17b-a16e", "--smoke",
                      "--dispatch", "bcsr", "--gen", "6", "--prompt-len", "8",
                      "--device", "cpu", "--quantize-experts", "int8",
                      "--kv-quant", "int8", *extra])
    assert "sample generations" in capsys.readouterr().out \
        or "--continuous" in extra
    (drv,) = made
    assert drv.quantize_experts == "int8" and drv.kv_quant == "int8"
    assert isinstance(drv.params["blocks"][0]["ffn"]["experts"]["w_up"],
                      QuantTensor)
    assert drv.cache["slots"][0]["attn"]["k"].dtype == torch.int8
    assert "k_scale" in drv.cache["slots"][0]["attn"]
    toks = (np.concatenate([np.asarray(t) for t in out.values()])
            if isinstance(out, dict) else np.asarray(out))
    assert toks.size and ((toks >= 0) & (toks < 256)).all()
    if not isinstance(out, dict):
        assert out.shape == (4, 6)
