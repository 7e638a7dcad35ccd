"""Port vs reference: the training path on the CPU.

The same inputs, made from numpy seeds (the reference's ``init_params``
for the weights, through ``interop.params_from_jax(train=True)``, which
keeps its f32 leaves), go through the reference and the port:

* AdamW (``optim.adamw``): three updates with and without clipping (a
  clip that bites and one that does not), a constant lr and the cosine
  schedule, f32 params and bf16 params with ``master_weights``: params,
  moments, master and count within 1e-6 of each leaf's largest |value|
  (f32 leaves; ``pow`` and ``sqrt`` may round differently) or one bf16
  ulp of it (bf16 leaves, rounded from those masters); the schedule and
  the global norm within 1e-6;
* ``SyntheticLM`` batches ``np.array_equal`` (tokens, frontend embeddings),
  and the ``Prefetcher`` hands them on unchanged;
* ``model.loss_fn`` and every gradient leaf against the reference's
  ``jax.value_and_grad`` for each SMOKE arch of the registry at the f32
  policy (loss within 1e-5, each leaf within 1e-4 of its largest |grad|:
  zamba2's ``a_log`` gradients are sums of many small terms), and
  qwen3-1.7b at the bf16 policy (loss within 2e-3, leaves within 5e-2:
  bf16 rounds at other places in the two frameworks);
* ``seq_chunk`` against none and ``microbatches=2`` against 1 (the port
  alone: within 1e-5);
* the ``grad_compress_k`` step against the reference's
  ``launch.train.make_step`` and 10-step loss trajectories of
  ``launch.steps.make_train_step`` against the reference's ``make_step``
  (losses within 1e-5; RWKV-6's within 1e-3, see ``TRAJ_TOL``);
* ``moe.load_balance_loss``, the sparse gradient exchange
  (``grad_comp``), ``model.forward`` and the stored dtype of
  ``init_params`` (f32 for training, serving's bf16 its rounding).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.grad_comp import sparse_allreduce as RSA
from repro.launch.train import make_step as r_make_step
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.optim import adamw as RA

from repro_torch import configs, to_tensor, tree
from repro_torch.data.pipeline import Prefetcher, SyntheticLM
from repro_torch.grad_comp import sparse_allreduce as SA
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.shapes import SHAPES, ShapeSpec
from repro_torch.launch.train import make_step
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm

torch.set_num_threads(2)
ARCHS = configs.ARCH_NAMES
F32, BF16 = torch.float32, torch.bfloat16
SHAPE = ShapeSpec("test", "train", 24, 2)


def _np(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    big = np.abs(want).max()
    return float(np.abs(got - want).max() / big) if big else float(
        np.abs(got).max())


@functools.lru_cache(maxsize=None)
def _build(arch, policy="f32"):
    rcfg = dataclasses.replace(r_get_smoke(arch), policy=policy)
    cfg = dataclasses.replace(configs.get_smoke(arch), policy=policy)
    rparams = jax.device_get(jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, rparams


def _params(arch, policy="f32"):
    rcfg, cfg, rparams = _build(arch, policy)
    return rcfg, cfg, rparams, params_from_jax(rparams, cfg, device="cpu",
                                               train=True)


def _batch(rcfg, seed=3, batch=2, seq=24):
    return RSyntheticLM(rcfg, batch=batch, seq_len=seq, seed=seed).batch_at(0)


# ------------------------------------------------------------- optimizer --

def _opt_tree(rng, bf16: bool):
    """A param tree of the model's kinds of leaves: 2-D and 3-D (decayed),
    1-D (not decayed), a tuple of slots."""
    mk = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = {"embed": mk(16, 8), "final_norm": {"scale": mk(8) + 1.0},
         "blocks": ({"w": mk(2, 8, 12), "ln": {"scale": mk(2, 8)}},
                    {"w": mk(2, 12, 8), "b": mk(2, 12)})}
    if bf16:
        p = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16)
                            if x.ndim >= 2 else jnp.asarray(x), p)
    return jax.tree.map(jnp.asarray, p)


@pytest.mark.parametrize("clip", [None, 1.0, 0.05])
@pytest.mark.parametrize("master", [False, True])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_adamw_matches_reference(clip, master, lr):
    rng = np.random.default_rng(21)
    rp = _opt_tree(rng, bf16=master)
    r_lr = 3e-2 if lr == "const" else RA.cosine_schedule(3e-2, 2, 10)
    p_lr = 3e-2 if lr == "const" else cosine_schedule(3e-2, 2, 10)
    ropt = RA.AdamW(lr=r_lr, clip_norm=clip, master_weights=master)
    opt = AdamW(lr=p_lr, clip_norm=clip, master_weights=master)
    rstate = ropt.init(rp)
    state = opt.init(tree.map(lambda x: to_tensor(x), rp))
    p = tree.map(lambda x: to_tensor(x), rp)
    for i in range(3):
        g = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape),
                                               x.dtype), rp)
        rp, rstate = ropt.update(g, rstate, rp)
        p, state = opt.update(tree.map(lambda x: to_tensor(x), g), state, p)
    assert int(state.count) == int(rstate.count) == 3
    got = tree.leaves({"p": p, "s": state})
    want = jax.tree.leaves({"p": rp, "s": rstate})
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == to_tensor(b).dtype
        if a.dtype == BF16:
            big = float(np.abs(_np(b)).max())
            ulp = 2.0 ** np.floor(np.log2(big)) * 2.0 ** -7
            assert np.abs(a.float().numpy() - _np(b)).max() <= ulp
        else:
            assert _rel(a, b) <= 1e-6


def test_cosine_schedule_and_global_norm_match_reference():
    lr, rlr = cosine_schedule(3e-4, 20, 250), RA.cosine_schedule(3e-4, 20,
                                                                  250)
    for c in (0, 1, 19, 20, 21, 100, 249, 250, 300):
        got = float(lr(torch.tensor(c, dtype=torch.int32)))
        want = float(rlr(jnp.asarray(c, jnp.int32)))
        assert abs(got - want) <= 1e-6 * 3e-4, c
    rp = _opt_tree(np.random.default_rng(22), bf16=True)
    got = float(global_norm(tree.map(lambda x: to_tensor(x), rp)))
    assert abs(got - float(RA.global_norm(rp))) <= 1e-6 * got


# ------------------------------------------------------------------ data --

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large"])
def test_synthetic_lm_is_the_reference_bit_for_bit(arch):
    rcfg = r_get_smoke(arch)
    cfg = configs.get_smoke(arch)
    ref, port = (cls(c, batch=3, seq_len=40, seed=5)
                 for cls, c in ((RSyntheticLM, rcfg), (SyntheticLM, cfg)))
    assert np.array_equal(ref.perm, port.perm)
    for step in (0, 1, 17):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key]), (step, key)


def test_prefetcher_hands_on_the_batches():
    data = SyntheticLM(configs.get_smoke("internvl2-26b"), batch=2,
                       seq_len=24, seed=1)
    pf = Prefetcher(data.stream(4), depth=2, device="cpu")
    try:
        for step in (4, 5, 6):
            got, want = next(pf), data.batch_at(step)
            for key in want:
                assert isinstance(got[key], torch.Tensor)
                assert np.array_equal(got[key].numpy(), want[key])
    finally:
        pf.close()
    assert not pf.t.is_alive()


# ------------------------------------------------------- loss and grads --

def _loss_and_grads(arch, policy):
    rcfg, cfg, rp, p = _params(arch, policy)
    b = _batch(rcfg)
    emb = b.get("embeddings")
    rl, rg = jax.jit(jax.value_and_grad(
        lambda q, t, e: RM.loss_fn(q, t, rcfg, embeddings=e)))(
        rp, b["tokens"], emb)
    tok, e = steps.inputs_on(p, b["tokens"], emb)
    l, g = steps.value_and_grad(
        lambda q: M.loss_fn(q, tok, cfg, embeddings=e), p)
    return float(l), float(rl), tree.leaves(g), jax.tree.leaves(rg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    l, rl, g, rg = _loss_and_grads(arch, "f32")
    assert abs(l - rl) <= 1e-5
    assert len(g) == len(rg)
    for a, b in zip(g, rg):
        assert tuple(a.shape) == b.shape and a.dtype == F32
        assert _rel(a, b) <= 1e-4


def test_loss_and_grads_match_reference_bf16():
    l, rl, g, rg = _loss_and_grads("qwen3-1.7b", "bf16")
    assert abs(l - rl) <= 2e-3
    for a, b in zip(g, rg):
        assert _rel(a, b) <= 5e-2


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "musicgen-large",
                                  "gemma3-12b"])
def test_seq_chunk_matches_unchunked(arch):
    """Chunks of 5 over 23 positions (4 whole chunks and a tail of 3)."""
    rcfg, cfg, _, p = _params(arch)
    b = _batch(rcfg)
    tok, e = steps.inputs_on(p, b["tokens"], b.get("embeddings"))
    outs = [steps.value_and_grad(lambda q: M.loss_fn(
        q, tok, cfg, embeddings=e, seq_chunk=sc), p) for sc in (None, 5)]
    (l0, g0), (l1, g1) = outs
    assert abs(float(l0) - float(l1)) <= 1e-5
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert _rel(b, a.numpy()) <= 1e-5


def test_forward_logits_match_reference():
    rcfg, cfg, rp, p = _params("qwen3-1.7b")
    b = _batch(rcfg)
    want = RM.forward(rp, b["tokens"], rcfg)
    got = M.forward(p, torch.from_numpy(b["tokens"]), cfg)
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "llama4-scout-17b-a16e",
                                  "internvl2-26b"])
def test_microbatches_match_one_batch(arch):
    rcfg, cfg, rp, p = _params(arch)
    b = _batch(rcfg, batch=4)
    outs = []
    for k in (1, 2):
        opt = AdamW(lr=1e-3)
        step = steps.make_train_step(cfg, ShapeSpec("t", "train", 24, 4),
                                     opt, seq_chunk=8, microbatches=k)
        outs.append(step(p, opt.init(p), b["tokens"], b.get("embeddings")))
    (p1, o1, m1), (p2, o2, m2) = outs
    assert abs(float(m1["loss"]) - float(m2["loss"])) <= 1e-5
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) \
        <= 1e-5 * float(m1["grad_norm"])
    for a, c in zip(tree.leaves(o1.m), tree.leaves(o2.m)):
        assert _rel(c, a.numpy()) <= 1e-5


def test_make_train_step_refuses_a_mesh():
    _, cfg, _, _ = _params("qwen3-1.7b")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        steps.make_train_step(cfg, SHAPES["train_4k"], mesh=object())


def test_grad_compress_step_matches_reference():
    rcfg, cfg, rp, p = _params("qwen3-1.7b")
    b = _batch(rcfg, batch=4, seq=32)
    ropt, opt = RA.AdamW(lr=3e-3), AdamW(lr=3e-3)
    rstep = r_make_step(rcfg, ropt, grad_compress_k=256)
    step = make_step(cfg, opt, grad_compress_k=256)
    rstate = ropt.init(rp)
    state = opt_state_from_jax(jax.device_get(rstate), device="cpu")
    rp2, _, rm = rstep(rp, rstate, jnp.asarray(b["tokens"]))
    p2, _, m = step(p, state, b["tokens"])
    assert abs(float(m["loss"]) - float(rm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) \
        <= 1e-4 * float(rm["grad_norm"])
    for a, c in zip(tree.leaves(p2), jax.tree.leaves(rp2)):
        assert _rel(a, c) <= 1e-5


# 10-step trajectories: losses within 1e-5, except RWKV-6's within 1e-3.
# Adam's first steps move a weight by about lr times the sign of its
# gradient, so an element whose gradient is near 0 can move by lr on one
# side and not the other (rwkv6's params differ by ~1e-3 of a leaf's
# largest value after one step, with gradients within 3e-6); RWKV-6's
# decay (an exp of an exp) carries that into the loss by step 8 (3e-4).
TRAJ_TOL = {"qwen3-1.7b": 1e-5, "llama4-scout-17b-a16e": 1e-5,
            "rwkv6-7b": 1e-3}


@pytest.mark.parametrize("arch", list(TRAJ_TOL))
def test_ten_step_trajectory_matches_reference(arch):
    """``make_train_step`` (remat, cross-entropy in chunks of 8) against
    the reference's ``make_step`` (one piece), 10 steps of ``SyntheticLM``
    batches from the same params and AdamW(3e-3): losses within
    ``TRAJ_TOL``."""
    rcfg, cfg, rp, p = _params(arch)
    data = RSyntheticLM(rcfg, batch=2, seq_len=24, seed=0)
    ropt, opt = RA.AdamW(lr=3e-3), AdamW(lr=3e-3)
    rstep = r_make_step(rcfg, ropt)
    step = steps.make_train_step(cfg, SHAPE, opt, seq_chunk=8)
    rstate, state = ropt.init(rp), opt.init(p)
    for i in range(10):
        tok = data.batch_at(i)["tokens"]
        rp, rstate, rm = rstep(rp, rstate, jnp.asarray(tok))
        p, state, m = step(p, state, tok)
        assert abs(float(m["loss"]) - float(rm["loss"])) <= TRAJ_TOL[arch], i


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(23)
    logits = rng.normal(size=(40, 8)).astype(np.float32)
    eid = rng.integers(0, 8, size=40).astype(np.int32)
    want = float(RMoE.load_balance_loss(jnp.asarray(logits),
                                        jnp.asarray(eid), 8))
    got = float(moe.load_balance_loss(torch.from_numpy(logits),
                                      torch.from_numpy(eid), 8))
    assert abs(got - want) <= 1e-6 * want


# ------------------------------------------------------- grad exchange --

def test_sparse_gradient_exchange_matches_reference():
    rng = np.random.default_rng(24)
    g = rng.normal(size=(3, 200)).astype(np.float32)
    err = rng.normal(size=200).astype(np.float32) * 0.1
    rk_, rv, re = RSA.compress(jnp.asarray(g[0]), 16, jnp.asarray(err))
    k_, v, e = SA.compress(torch.from_numpy(g[0]), 16, torch.from_numpy(err))
    assert np.array_equal(k_.numpy(), np.asarray(rk_))
    assert np.array_equal(v.numpy(), np.asarray(rv))
    assert np.array_equal(e.numpy(), np.asarray(re))
    rdense, rerrs = RSA.sparse_allreduce_tree(jnp.asarray(g), 16)
    dense, errs = SA.sparse_allreduce_tree(torch.from_numpy(g), 16)
    assert np.allclose(dense.numpy(), np.asarray(rdense), atol=1e-6)
    assert np.array_equal(errs.numpy(), np.asarray(rerrs))
    keys = np.stack([np.sort(rng.choice(50, 8, replace=False))
                     for _ in range(3)]).astype(np.int32)
    vals = rng.normal(size=(3, 8)).astype(np.float32)
    rk2, rv2, rc = RSA.union_reduce(jnp.asarray(keys), jnp.asarray(vals))
    k2, v2, c = SA.union_reduce(torch.from_numpy(keys),
                                torch.from_numpy(vals))
    assert int(c) == int(rc)
    assert np.array_equal(k2.numpy(), np.asarray(rk2))
    assert np.allclose(v2.numpy(), np.asarray(rv2), atol=1e-6)
    assert SA.compression_ratio(10**6, 1000, 8) == \
        RSA.compression_ratio(10**6, 1000, 8)


# ---------------------------------------------------------------- init --

def test_init_params_stores_f32_for_training():
    """``param_dtype=torch.float32`` stores the matmul weights in f32 with
    the same draws; serving's default (bf16 under the bf16 policy) is their
    rounding, bit for bit."""
    cfg = configs.get_smoke("qwen3-1.7b")
    train = M.init_params(cfg, device="cpu", param_dtype=F32)
    serve = M.init_params(cfg, device="cpu")
    for a, b in zip(tree.leaves(train), tree.leaves(serve)):
        assert a.dtype == F32
        assert torch.equal(a.to(b.dtype), b)
    assert serve["embed"].dtype == BF16
