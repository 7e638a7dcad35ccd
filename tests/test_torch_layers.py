"""Port vs reference: norms, RoPE, attention (prefill + decode, chunked,
kernel, masked and oracle prefill) and MLPs.

Same numpy-seeded inputs through the reference (``repro.models.layers``,
``repro.kernels.flash_attention.ops``) and the port, f32, atol 1e-5: the
two frameworks sum in other orders, nothing else differs.  The decode KV
cache is bf16 as in serving, so decode also checks the reference's cast
order (q cast to the cache dtype, unnormalized weights cast before PV).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.masks import AttnMaskSpec as RAttnMaskSpec
from repro.kernels.flash_attention import ops as r_fops
from repro.models import layers as RL
from repro.models.config import ArchConfig as RArchConfig

from repro_torch.core.masks import AttnMaskSpec
from repro_torch.interop import params_from_jax, to_tensor
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=0)
# one compiled program per call shape instead of op-by-op eager dispatch
r_attention = jax.jit(RL.apply_attention, static_argnames=("cfg", "collect_kv"))

CFG_KW = dict(name="tiny-attn", family="dense", d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=48, vocab_size=64, block_unit=("attn",),
              n_repeats=1, head_dim=16, policy="f32")
VARIANTS = {"plain": {}, "bias+qknorm": dict(qkv_bias=True, qk_norm=True)}


def _cfgs(**kw):
    return RArchConfig(**CFG_KW, **kw), ArchConfig(**CFG_KW, **kw)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(a):
    return np.asarray(a, np.float32)


def _bf(a):
    return np.asarray(a)            # ml_dtypes bf16 array


def test_rmsnorm_and_rope():
    x = _x((2, 3, 5, 16))
    scale = 1.0 + 0.1 * _x((16,), 1)
    np.testing.assert_allclose(
        L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        _np(RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))), **TOL)
    pos = np.arange(5) + 11
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy(),
        _np(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), **TOL)


@pytest.mark.parametrize("window,chunk", [(None, 1024), (None, 8), (6, 8)])
def test_chunked_attention(window, chunk):
    q, k, v = _x((2, 4, 20, 16), 1), _x((2, 2, 20, 16), 2), _x((2, 2, 20, 16), 3)
    got = L.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, chunk=chunk)
    want = RL.chunked_attention(*map(jnp.asarray, (q, k, v)), window=window,
                                chunk=chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("kv_len,window", [(None, None), (7, None), (9, 4)])
def test_decode_attention_bf16_cache(kv_len, window):
    q = _x((2, 4, 1, 16), 4)
    k, v = _x((2, 2, 12, 16), 5), _x((2, 2, 12, 16), 6)
    kb, vb = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
    want = r_fops.decode_attention(jnp.asarray(q), kb, vb, kv_len=kv_len,
                                   window=window)
    got = fops.decode_attention(torch.from_numpy(q), to_tensor(_bf(kb)),
                                to_tensor(_bf(vb)), kv_len=kv_len,
                                window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_attention_prefill_then_decode(variant):
    rcfg, cfg = _cfgs(**VARIANTS[variant])
    rp = RL.init_attention(jax.random.PRNGKey(0), rcfg)
    if rcfg.qkv_bias:               # nonzero biases so they are exercised
        rp = {**rp, **{b: rp[b] + 0.1 for b in ("bq", "bk", "bv")}}
    p = params_from_jax(jax.device_get(rp), cfg, device="cpu")
    B, S, MAX = 2, 7, 10
    x = _x((B, S, 32), 7)
    want, rcache = r_attention(rp, jnp.asarray(x), rcfg, collect_kv=MAX)
    got, cache = L.apply_attention(p, torch.from_numpy(x), cfg, collect_kv=MAX)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for f in ("k", "v"):
        np.testing.assert_allclose(cache[f].numpy(), _np(rcache[f]), **TOL)

    # one decode step on the prefill cache held in bf16 (serving's dtype)
    rc = {f: rcache[f].astype(jnp.bfloat16) for f in ("k", "v")}
    c = {f: to_tensor(_bf(rc[f])) for f in ("k", "v")}
    x1 = _x((B, 1, 32), 8)
    want1, rnew = r_attention(rp, jnp.asarray(x1), rcfg, cache=rc,
                              cache_len=jnp.asarray(S, jnp.int32))
    got1, new = L.apply_attention(p, torch.from_numpy(x1), cfg, cache=c,
                                  cache_len=S)
    assert new is c                 # updated in place
    np.testing.assert_allclose(got1.numpy(), _np(want1), **TOL)
    for f in ("k", "v"):
        np.testing.assert_array_equal(new[f].float().numpy(), _np(rnew[f]))


def _attn_params(variant="plain"):
    rcfg, cfg = _cfgs(**VARIANTS[variant])
    rp = RL.init_attention(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rp, params_from_jax(jax.device_get(rp), cfg,
                                          device="cpu")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_apply_attention_kernel_matches_reference(variant):
    """impl="kernel" (K3 through ops.attention, plain on the CPU) vs the
    reference's flash path in interpret mode on the same q/k/v.  The
    reference's own ``apply_attention(impl="kernel")`` cannot run on a CPU
    (it calls the Pallas kernel without ``interpret=``)."""
    rcfg, cfg, rp, p = _attn_params(variant)
    B, S = 2, 20
    x = _x((B, S, 32), 10)
    q, k, v = RL._qkv(rp, jnp.asarray(x), rcfg, jnp.arange(S))
    o = r_fops.attention(q, k, v, causal=True, bq=8, bk=8, interpret=True)
    want = o.transpose(0, 2, 1, 3).reshape(B, S, -1) @ rp["wo"]
    got, _ = L.apply_attention(p, torch.from_numpy(x), cfg, impl="kernel")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("impl", ["sparse", "dense", "ref"])
def test_apply_attention_masked_prefill_matches_reference(impl):
    """attn_mask= sends prefill through the masked kernels (plain on the
    CPU); the reference runs its own in interpret mode.  Explicit tiles and
    window: the mask's meaning depends on them."""
    rcfg, cfg, rp, p = _attn_params()
    x = _x((2, 24, 32), 11)
    kw = dict(local=True, pattern="local_global", window=8, bq=8, bk=8,
              impl=impl)
    want, _ = RL.apply_attention(rp, jnp.asarray(x), rcfg,
                                 attn_mask=RAttnMaskSpec(**kw))
    got, _ = L.apply_attention(p, torch.from_numpy(x), cfg,
                               attn_mask=AttnMaskSpec(**kw))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # a spec that does not apply to a full-attention layer leaves impl
    got_none, _ = L.apply_attention(p, torch.from_numpy(x), cfg,
                                    attn_mask=AttnMaskSpec(pattern=None))
    plain, _ = L.apply_attention(p, torch.from_numpy(x), cfg)
    assert torch.equal(got_none, plain)


def test_apply_attention_ref_matches_reference():
    rcfg, cfg, rp, p = _attn_params()
    x = _x((2, 9, 32), 12)
    want, _ = RL.apply_attention(rp, jnp.asarray(x), rcfg, impl="ref")
    got, _ = L.apply_attention(p, torch.from_numpy(x), cfg, impl="ref")
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_apply_attention_refuses_unported_paths():
    rcfg, cfg, rp, p = _attn_params()
    x = _x((1, 4, 32))
    with pytest.raises(NotImplementedError):
        L.apply_attention(p, torch.from_numpy(x), cfg, impl="shard_map")
    # the single-device kernel_sharded path is ported: its forward is K3's
    kern, _ = L.apply_attention(p, torch.from_numpy(x), cfg, impl="kernel")
    shard, _ = L.apply_attention(p, torch.from_numpy(x), cfg,
                                 impl="kernel_sharded")
    assert torch.equal(shard, kern)
    # ring-buffer caches are ported: a collect at S >= window keeps the
    # last `window` positions at their slots (pos % window), as the
    # reference's does
    _, ring = L.apply_attention(p, torch.from_numpy(x), cfg, window=3,
                                collect_kv=8)
    _, rring = RL.apply_attention(rp, jnp.asarray(x), rcfg, window=3,
                                  collect_kv=8)
    for name in ("k", "v"):
        assert ring[name].shape[2] == 3
        np.testing.assert_allclose(ring[name].numpy(), _np(rring[name]),
                                   **TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "squared_relu"])
def test_apply_mlp(mlp_type):
    rcfg, cfg = _cfgs(mlp_type=mlp_type)
    rp = RL.init_mlp(jax.random.PRNGKey(1), rcfg)
    p = params_from_jax(jax.device_get(rp), cfg, device="cpu")
    x = _x((2, 5, 32), 9)
    np.testing.assert_allclose(
        L.apply_mlp(p, torch.from_numpy(x), cfg).numpy(),
        _np(RL.apply_mlp(rp, jnp.asarray(x), rcfg)), **TOL)
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(cfg)
