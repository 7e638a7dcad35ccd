"""Port vs reference: zamba2-1.2b serving on the CPU.

zamba2-1.2b is a hybrid stack: ``n_prologue`` Mamba-2 layers, then
``block_unit`` (Mamba-2 layers) x ``n_repeats``, with one shared attention
block (one weight set, MHA) after every ``shared_attn_every``-th repeat.
Held on its SMOKE config (f32 policy; weights from the reference's
``init_params`` through ``interop.params_from_jax``; inputs from numpy
seeds), under ``shared_attn_every`` 1 and 2 (the second through
``dataclasses.replace``, on both sides):

* the configs, field for field, and ``param_count``; the params' tree;
* ``ssd_chunked`` against the reference's at T 3-90 and chunks 4 / 16 / 64
  / 256, and against the port's sequential ``mamba_scan_ref``, within 1e-5
  of the largest |value|; ``apply_mamba`` prefill (collected cache) and
  decode against the reference's, within 1e-5;
* ``model.prefill`` logits at S 8 / 16 / 20 within 1e-4 and the collected
  cache leaf for leaf (the prologue's and the shared block's included)
  within 1e-5; decode steps at an int and a ``(B,)`` position against the
  reference's ``decode_step`` (the same bounds), the vector path
  ``torch.equal`` to the int path; masked prefill on the shared block;
* greedy ``ServeScheduler`` tokens (fused and two-phase) equal to the
  reference's gather scheduler and to each request alone through
  ``ServeLoop``; fused == layered (tokens, first decode logits
  ``torch.equal``, greedy and at 0.7); int8 KV fused == layered and ==
  alone;
* D1 at the shared block's GQA group of 1 (D 64): its plain version and
  its order against the reference's ``decode_attention`` (bf16, f32, and
  an int8 cache dequantized to bf16 as decode feeds it), rows at B 1-16
  == alone;
* the walks over the cache that must see Mamba's state: the retry's save
  (a retried step's pool == the fault-free run's, and != without the
  save), ``_FusedDecode.load`` and the scheduler's row copy (the prologue
  included), ``cache_capacity`` (the shared slot); the CLI.

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
from repro.kernels.flash_attention import ops as rfops
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import mamba2 as RMB
from repro.models import model as RM

from repro_torch import configs
from repro_torch.core import precision
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import mamba2
from repro_torch.models import model as M
from repro_torch.runtime import resilience as R

torch.set_num_threads(2)
ARCH = "zamba2-1.2b"
B = 2
MAX_SEQ = 32
LOGIT_TOL, CACHE_TOL, SSD_TOL = 1e-4, 1e-5, 1e-5


@functools.lru_cache(maxsize=None)
def _build(every=1):
    rcfg = dataclasses.replace(r_get_smoke(ARCH), policy="f32",
                               shared_attn_every=every)
    cfg = dataclasses.replace(configs.get_smoke(ARCH), policy="f32",
                              shared_attn_every=every)
    rparams = jax.device_get(jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg))
    return rcfg, cfg, rparams, params_from_jax(rparams, cfg, device="cpu")


def _prompts(S, seed=None, rows=B):
    vocab = configs.get_smoke(ARCH).vocab_size
    return np.random.default_rng(S if seed is None else seed).integers(
        0, vocab, (rows, S)).astype(np.int32)


def _np(t):
    return t.float().numpy().astype(np.float64) if isinstance(
        t, torch.Tensor) else np.asarray(jnp.asarray(t, jnp.float32),
                                         np.float64)


def _close(got, want, rel, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


def _paths(tree, pre=""):
    """(path, leaf) of every leaf of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{pre}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in _paths(v,
                                                              f"{pre}/{i}")]
    return [(pre, tree)]


def _leaves(tree):
    return [leaf for _, leaf in _paths(tree)]


def _close_caches(cache, rcache, rel, what):
    """Leaf for leaf, the same paths on both sides."""
    mine, ref = _paths(cache), dict(_paths(jax.device_get(rcache)))
    assert [p for p, _ in mine] == sorted(ref), what
    for path, leaf in mine:
        _close(leaf, ref[path], rel, f"{what} {path}")


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_equals_reference(which):
    """``get_config`` / ``get_smoke`` field for field the reference's, the
    same ``param_count``, and the family's shape."""
    get = {"CONFIG": (configs.get_config, r_get_config),
           "SMOKE": (configs.get_smoke, r_get_smoke)}[which]
    cfg, rcfg = get[0](ARCH), get[1](ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert cfg.param_count() == rcfg.param_count()
    assert ARCH in configs.ARCH_NAMES
    assert set(cfg.block_unit) == {"mamba"} and cfg.n_prologue
    assert cfg.shared_attn_every == 1 and cfg.n_heads == cfg.n_kv_heads
    if which == "CONFIG":
        assert cfg.n_layers == 38 and cfg.param_count() == 1_170_308_864


@pytest.mark.parametrize("every", [1, 2])
def test_params_tree_matches_reference(every):
    """``init_params`` gives the reference's tree leaf for leaf (path,
    shape; the shared block unstacked, the prologue stacked); ``a_log``,
    ``d_skip`` and ``dt_bias`` cross as f32 under the bf16 policy."""
    _, cfg, rparams, params = _build(every)
    mine = M.init_params(cfg, device="cpu")
    shapes = lambda t: [(p, tuple(x.shape), x.dtype) for p, x in _paths(t)]  # noqa: E731
    assert shapes(mine) == shapes(params)
    assert [(p, tuple(x.shape)) for p, x in _paths(params)] == [
        (p, tuple(np.shape(x))) for p, x in _paths(rparams)]
    assert params["prologue"]["mixer"]["w_in"].shape[0] == cfg.n_prologue
    assert params["shared_attn"]["attn"]["wq"].dim() == 2
    bf = params_from_jax(rparams, dataclasses.replace(cfg, policy="bf16"),
                         device="cpu")
    mixer = bf["blocks"][0]["mixer"]
    assert {k: v.dtype for k, v in mixer.items() if k != "norm"} == {
        "w_in": torch.bfloat16, "conv_w": torch.bfloat16,
        "conv_b": torch.bfloat16, "w_out": torch.bfloat16,
        "a_log": torch.float32, "d_skip": torch.float32,
        "dt_bias": torch.float32}


# ------------------------------------------------------------------- ssd --

def _ssd_inputs(T, seed, h0=False):
    rng = np.random.default_rng(seed)
    Bn, nh, hd, ns = 2, 3, 4, 5
    xh = rng.normal(size=(Bn, T, nh, hd)).astype(np.float32)
    a_log = -rng.uniform(0.01, 0.5, (Bn, T, nh)).astype(np.float32)
    Bv = rng.normal(size=(Bn, T, ns)).astype(np.float32)
    Cv = rng.normal(size=(Bn, T, ns)).astype(np.float32)
    out = [xh, a_log, Bv, Cv]
    if h0:
        out.append(rng.normal(size=(Bn, nh, hd, ns)).astype(np.float32))
    return out


@pytest.mark.parametrize("T", [3, 17, 64, 90])
@pytest.mark.parametrize("chunk", [4, 16, 64, 256])
def test_ssd_chunked_matches_reference_and_scan(T, chunk):
    """``ssd_chunked`` against the reference's (y and the final state) and
    against the port's sequential ``mamba_scan_ref``, within 1e-5 of the
    largest |value|; a carried-in state where T is odd."""
    arrs = _ssd_inputs(T, seed=T + chunk, h0=bool(T % 2))
    h0 = arrs[4] if len(arrs) > 4 else None
    t = [torch.from_numpy(a) for a in arrs[:4]]
    th0 = None if h0 is None else torch.from_numpy(h0)
    y, h = mamba2.ssd_chunked(*t, chunk=chunk, h0=th0)
    ry, rh = RMB.ssd_chunked(*(jnp.asarray(a) for a in arrs[:4]),
                             chunk=chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    _close(y, ry, SSD_TOL, f"y T={T} chunk={chunk}")
    _close(h, rh, SSD_TOL, f"state T={T} chunk={chunk}")
    sy, sh = mamba2.mamba_scan_ref(*t, h0=th0)
    _close(y, sy, SSD_TOL, f"y vs scan T={T} chunk={chunk}")
    _close(h, sh, SSD_TOL, f"state vs scan T={T} chunk={chunk}")


def test_scan_ref_matches_reference_scan():
    """The port's oracle is the reference's ``mamba_scan_ref``."""
    arrs = _ssd_inputs(11, seed=5, h0=True)
    sy, sh = mamba2.mamba_scan_ref(*(torch.from_numpy(a) for a in arrs[:4]),
                                   h0=torch.from_numpy(arrs[4]))
    ry, rh = RMB.mamba_scan_ref(*(jnp.asarray(a) for a in arrs))
    _close(sy, ry, 1e-6, "scan y")
    _close(sh, rh, 1e-6, "scan state")


@pytest.mark.parametrize("T", [5, 20])
def test_apply_mamba_prefill_and_decode_match_reference(T):
    """``apply_mamba`` on the first layer's weights: prefill out and its
    collected ``conv`` / ``ssm``, then three decode steps from that cache
    (out and cache, the step in place), within 1e-5."""
    rcfg, cfg, rparams, params = _build()
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"][0]["mixer"])
    p = M._take(params["blocks"][0]["mixer"], 0)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(B, T + 3, cfg.d_model)).astype(np.float32)
    ro, rc = RMB.apply_mamba(rp, jnp.asarray(x[:, :T]), rcfg, collect=True)
    out, c = mamba2.apply_mamba(p, torch.from_numpy(x[:, :T]), cfg,
                                collect=True)
    _close(out, ro, SSD_TOL, "prefill out")
    _close_caches(c, rc, SSD_TOL, "prefill cache")
    ptr = c["ssm"].data_ptr()
    for t in range(T, T + 3):
        ro, rc = RMB.apply_mamba(rp, jnp.asarray(x[:, t:t + 1]), rcfg,
                                 cache=rc)
        out, c2 = mamba2.apply_mamba(p, torch.from_numpy(x[:, t:t + 1]),
                                     cfg, cache=c)
        assert c2 is c and c["ssm"].data_ptr() == ptr
        _close(out, ro, SSD_TOL, f"decode out at {t}")
        _close_caches(c, rc, SSD_TOL, f"decode cache at {t}")


# --------------------------------------------------------------- prefill --

@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("S", [8, 16, 20])
def test_prefill_logits_and_caches_match_reference(every, S):
    """``M.prefill`` against the reference's: logits within 1e-4, the f32
    cache leaf for leaf within 1e-5 (prologue, mamba slots, and the shared
    block's slot, collected at every repeat)."""
    rcfg, cfg, rparams, params = _build(every)
    prompts = _prompts(S)
    rl, rc, rpos = RM.prefill(rparams, jnp.asarray(prompts), rcfg,
                              max_seq=MAX_SEQ, cache_dtype=jnp.float32)
    logits, cache, pos = M.prefill(params, torch.from_numpy(prompts).long(),
                                   cfg, max_seq=MAX_SEQ,
                                   cache_dtype=torch.float32)
    assert pos == int(rpos) == S
    _close(logits, rl, LOGIT_TOL, f"prefill S={S}")
    _close_caches(cache, rc, CACHE_TOL, f"prefill S={S}")
    layered = M.prefill_layered(params, torch.from_numpy(prompts).long(),
                                cfg, max_seq=MAX_SEQ,
                                cache_dtype=torch.float32)
    assert torch.equal(layered[0], logits)


@pytest.mark.parametrize("every", [1, 2])
def test_masked_prefill_matches_reference(every):
    """``attn_mask=local_global`` (window 8) reaches the shared block: the
    port's plain K4s against the reference's masked prefill (its kernels in
    interpret mode), logits within 1e-4 and caches within 1e-5; K4m
    ``torch.equal`` to K4s."""
    rcfg, cfg, rparams, params = _build(every)
    prompts = _prompts(24, seed=7)
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
    _close(out["sparse"][0], rl, LOGIT_TOL, "masked prefill")
    _close_caches(out["sparse"][1], rc, CACHE_TOL, "masked")
    assert torch.equal(out["sparse"][0], out["dense"][0])


# ---------------------------------------------------------------- decode --

def _stacked_prefill(every, lengths):
    """Each row's prompt prefilled alone (B = 1) on both sides, the rows'
    caches concatenated: rows at their own positions."""
    rcfg, cfg, rparams, params = _build(every)
    rows, rrows, firsts = [], [], []
    for i, S in enumerate(lengths):
        pr = _prompts(S, seed=100 + i, rows=1)
        rl, rc, _ = RM.prefill(rparams, jnp.asarray(pr), rcfg,
                               max_seq=MAX_SEQ, cache_dtype=jnp.float32)
        _, c, _ = M.prefill(params, torch.from_numpy(pr).long(), cfg,
                            max_seq=MAX_SEQ, cache_dtype=torch.float32)
        rows.append(c)
        rrows.append(rc)
        firsts.append(np.argmax(np.asarray(rl)[:, -1, :cfg.vocab_size], -1))

    def cat(*trees):
        if isinstance(trees[0], dict):
            return {k: cat(*(t[k] for t in trees)) for k in trees[0]}
        if isinstance(trees[0], tuple):
            return tuple(cat(*xs) for xs in zip(*trees))
        return torch.cat(trees, 1)

    rcache = jax.tree.map(lambda *xs: jnp.concatenate(xs, 1), *rrows)
    tok = np.stack(firsts).astype(np.int32).reshape(-1, 1)
    return cat(*rows), rcache, tok


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("kind,lengths", [("int", (12, 12)),
                                          ("vector", (9, 14))])
def test_decode_matches_reference(every, kind, lengths):
    """Five decode steps at an int and at a ``(B,)`` position against the
    reference's ``decode_step``: logits within 1e-4 each step, the f32
    cache within 1e-5 after the last (the shared slot's rows untouched off
    a fire step); at equal positions the vector path ``torch.equal`` to
    the int path."""
    rcfg, cfg, rparams, params = _build(every)
    cache, rcache, tok = _stacked_prefill(every, lengths)
    pos = np.array(lengths)
    for _ in range(5):
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
        c_int, _, tok0 = _stacked_prefill(every, lengths)
        c_vec = serve._clone_leaves(c_int)
        M.to_decode_dtypes(cfg, c_vec)
        t = torch.from_numpy(tok0).long()
        a, _ = M.decode_step_layered(params, cfg, c_int, lengths[0], t)
        b, _ = M.decode_step(params, cfg, c_vec,
                             torch.tensor(list(lengths)), t)
        assert torch.equal(a, b)
        assert all(torch.equal(x, y) for x, y in
                   zip(_leaves(c_int), _leaves(c_vec)))


def test_decode_cache_dtypes_and_layout():
    """``init_cache``'s mamba leaves (conv in the cache dtype, ssm f32), the
    shared block's slot after the block unit's and the prologue's stack;
    under the bf16 policy a prefill keeps ssm f32 and conv bf16, under f32
    both become ``cache_dtype`` and ``to_decode_dtypes`` widens them back,
    the prologue's too."""
    cfg = configs.get_smoke(ARCH)
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    c = M.init_cache(cfg, 3, MAX_SEQ, device="cpu", kv_quant="int8")
    assert len(c["slots"]) == len(cfg.block_unit) + 1
    assert c["slots"][0]["conv"].shape == (cfg.n_repeats, 3, 3,
                                           d_in + 2 * cfg.ssm_state)
    assert c["slots"][0]["conv"].dtype == torch.bfloat16
    assert c["slots"][0]["ssm"].shape == (cfg.n_repeats, 3, nh,
                                          cfg.ssm_head_dim, cfg.ssm_state)
    assert c["slots"][0]["ssm"].dtype == torch.float32
    assert c["slots"][-1]["attn"]["k"].dtype == torch.int8
    assert c["slots"][-1]["attn"]["k"].shape == (
        cfg.n_repeats, 3, cfg.n_kv_heads, MAX_SEQ, cfg.hd)
    assert c["prologue"]["ssm"].shape[0] == cfg.n_prologue
    _, f32, _, params = _build()
    _, pc, _ = M.prefill(params, torch.from_numpy(_prompts(6)).long(), f32,
                         max_seq=MAX_SEQ)
    for slot in (pc["slots"][0], pc["prologue"]):
        assert slot["ssm"].dtype == slot["conv"].dtype == torch.bfloat16
    M.to_decode_dtypes(f32, pc)
    for slot in (pc["slots"][0], pc["prologue"]):
        assert slot["ssm"].dtype == slot["conv"].dtype == torch.float32


# ------------------------------------------------------- D1, group of 1 --

@pytest.mark.parametrize("qdt,cache", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("bfloat16", "int8")])
def test_decode_attention_at_a_group_of_1(qdt, cache):
    """D1 at zamba2-1.2b's shared block shape (MHA: a GQA group of 1; D
    64): the plain version and D1's order (``ref.decode_attention_ordered``)
    against the reference's ``decode_attention`` at per-row lengths,
    within one ulp of the largest |value| in bf16 (2e-6 of it in f32); the
    order's rows at B 1-16 ``torch.equal`` to the row alone.  ``int8``:
    K / V quantized per position and dequantized to bf16, as decode feeds
    D1 a quantized cache."""
    rng = np.random.default_rng(21)
    B, H, S, D = 16, 4, 48, 64
    qd = getattr(torch, qdt)
    q = torch.from_numpy(rng.normal(size=(B, H, 1, D)).astype(np.float32)
                         ).to(qd)
    kv = [torch.from_numpy(rng.normal(size=(B, H, S, D)).astype(np.float32))
          for _ in range(2)]
    if cache == "int8":
        kv = [precision.dequantize_rows(*precision.quantize_rows(
            t, "int8", check=False), torch.bfloat16) for t in kv]
    else:
        kv = [t.to(getattr(torch, cache)) for t in kv]
    k, v = kv
    lens = rng.integers(1, S + 1, B)
    lens[:2] = (1, S)
    kv_len = torch.from_numpy(lens)
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = np.asarray(rfops.decode_attention(
        *(jnp.asarray(t.float().numpy()).astype(jd[t.dtype])
          for t in (q, k, v)), kv_len=jnp.asarray(lens)).astype(jnp.float32))
    big = float(np.abs(want).max())
    ulp = torch.finfo(torch.bfloat16).eps
    tol = (2e-6 * big if qd == torch.float32 and k.dtype == torch.float32
           else 2.0 ** np.floor(np.log2(big)) * ulp)
    for got in (fops.decode_attention(q, k, v, kv_len=kv_len),
                fref.decode_attention_ordered(q, k, v, kv_len=kv_len)):
        assert got.dtype == qd
        assert np.abs(got.float().numpy() - want).max() <= tol
    alone = [fref.decode_attention_ordered(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], kv_len=kv_len[i:i + 1])
             for i in range(B)]
    for rows in (1, 2, 3, 4, 8, 16):
        out = fref.decode_attention_ordered(q[:rows], k[:rows], v[:rows],
                                            kv_len=kv_len[:rows])
        for i in range(rows):
            assert torch.equal(out[i:i + 1], alone[i]), (rows, i)


# ------------------------------------------------------------ scheduling --

def _trace():
    """Four requests: prompts of 6-15 tokens, budgets 4-9."""
    rng = np.random.default_rng(0)
    vocab = configs.get_smoke(ARCH).vocab_size
    return [(rng.integers(0, vocab, int(rng.integers(6, 16))
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
def _reference_tokens(every):
    rcfg, _, rparams, _ = _build(every)
    return _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch="gather"), _trace())


@pytest.mark.parametrize("every", [1, 2])
@pytest.mark.parametrize("two_phase", [False, True])
def test_scheduler_matches_reference_and_alone(every, two_phase):
    """Greedy ``ServeScheduler`` tokens (fused: one decode step a bucket
    over the pool's rows; two-phase: layered) == the reference's gather
    scheduler's, per request, and == each request alone through
    ``ServeLoop``."""
    _, cfg, _, params = _build(every)
    reqs = _trace()
    got = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                device="cpu", two_phase=two_phase), reqs)
    want = _reference_tokens(every)
    assert sorted(got) == sorted(want)
    for uid in want:
        assert np.array_equal(got[uid], want[uid]), uid
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], got[uid]), uid


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_fused_equals_layered(temperature):
    """``ServeLoop`` fused (the default) and layered give the same tokens,
    and the same first decode step logits, ``torch.equal``."""
    _, cfg, _, params = _build()
    assert not ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu").two_phase
    prompts = _prompts(14, seed=11)
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


def test_kv_quant_serving_fused_equals_layered_and_alone():
    """int8 KV (the shared block's cache): prefill logits ``torch.equal``
    to wide; ``ServeLoop`` fused == layered tokens; the fused scheduler's
    requests == alone under the same ``kv_quant``."""
    _, cfg, _, params = _build()
    toks = torch.from_numpy(_prompts(12, seed=9)).long()
    wide, _, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    narrow, cache, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ,
                                 kv_quant="int8")
    assert torch.equal(wide, narrow)
    assert cache["slots"][-1]["attn"]["k"].dtype == torch.int8
    got = [ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     two_phase=tp, kv_quant="int8").run(toks.numpy(), 8)
           for tp in (False, True)]
    assert np.array_equal(*got)
    reqs = _trace()
    sched = _drive(ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                                  device="cpu", kv_quant="int8"), reqs)
    loop = ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu",
                     kv_quant="int8")
    for uid, (p, g) in enumerate(reqs):
        assert np.array_equal(loop.run(p[None], g)[0], sched[uid]), uid


# ----------------------------------------------------- walks of the cache --

@pytest.mark.parametrize("two_phase", [False, True])
def test_retried_step_leaves_the_pool_as_the_fault_free_run(two_phase,
                                                            monkeypatch):
    """A ``sample`` exception after a step, retried from the saved step
    state (``conv`` / ``ssm``, the prologue's too): every request, and
    every pool leaf after every step, ``torch.equal`` to the fault-free
    run's.  Without the save the retried step advances the state twice and
    the pool parts from the fault-free run's."""
    _, cfg, _, params = _build()
    reqs = _trace()
    saved = serve._step_state(M.init_cache(cfg, 1, MAX_SEQ, device="cpu"))
    assert [sorted(s) for s in saved] == [["conv", "ssm"]] * (
        len(cfg.block_unit)) + [[], ["conv", "ssm"]]

    def run(**kw):
        """The scheduler driven as :func:`_drive`, its pool after each
        step kept."""
        s = ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                           device="cpu", two_phase=two_phase, **kw)
        for prompt, gen in reqs[:3]:
            s.submit(prompt, gen)
        pools, late = [], False
        while s.has_work():
            s.step()
            pools.append(_leaves(serve._clone_leaves(s.cache)))
            if s.step_idx == 2 and not late:
                s.submit(*reqs[3])
                late = True
        return pools, s.run()

    def same(a, b):
        return len(a) == len(b) and all(
            torch.equal(x, y) for pa, pb in zip(a, b) for x, y in zip(pa, pb))

    clean, want = run()
    plan = R.FaultPlan.single("sample", "exception", step=4)
    faulted, got = run(fault_plan=plan)
    assert plan.triggered and sorted(want) == [0, 1, 2, 3]
    assert all(np.array_equal(got[u], want[u]) for u in want)
    assert same(clean, faulted)
    monkeypatch.setattr(ServeScheduler, "_keep_step_state",
                        lambda self, bucket, retry: None)
    plan = R.FaultPlan.single("sample", "exception", step=4)
    unsaved, _ = run(fault_plan=plan)
    assert plan.triggered and not same(clean, unsaved)


def test_fused_load_and_row_copy_cover_the_prologue():
    """``_FusedDecode.load`` copies the prefill cache whole into the static
    cache, the prologue's state included; an admission copies the
    request's prefill cache into its pool row, prologue included."""
    _, cfg, _, params = _build()
    toks = torch.from_numpy(_prompts(10, seed=3)).long()
    _, pc, _ = M.prefill(params, toks, cfg, max_seq=MAX_SEQ)
    step = serve._FusedDecode(params, cfg, B, MAX_SEQ, dispatch="gather",
                              cache_dtype=torch.bfloat16,
                              device=torch.device("cpu"))
    step.load(pc)
    M.to_decode_dtypes(cfg, pc)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(step.cache),
                                                  _leaves(pc)))
    assert step.cache["prologue"]["ssm"].abs().sum() > 0
    sched = ServeScheduler(params, cfg, max_seq=MAX_SEQ, max_slots=2,
                           device="cpu")
    p = _prompts(9, seed=4, rows=1)[0]
    sched.submit(p, 3)
    sched.admit()
    _, one, _ = M.prefill(params, torch.from_numpy(p[None]).long(), cfg,
                          max_seq=MAX_SEQ, cache_dtype=sched.cache_dtype)
    row = sched.slots.index(next(r for r in sched.slots if r is not None))
    for pool, mine in zip(_leaves(sched.cache), _leaves(one)):
        assert torch.equal(pool[:, row], mine[:, 0].to(pool.dtype))
    assert sched.cache["prologue"]["conv"][:, row].abs().sum() > 0


def test_cache_capacity_counts_the_shared_slot():
    """The shared block's K/V is a full-context cache: ``cache_capacity``
    is ``max_seq`` (None only for a stack without it), a write at
    ``max_seq`` is refused by both decode entry points."""
    _, cfg, _, params = _build()
    cache = M.to_decode_dtypes(cfg, M.init_cache(
        cfg, B, 24, dtype=torch.float32, device="cpu"))
    assert M.cache_capacity(cache, cfg) == 24
    none = dataclasses.replace(cfg, shared_attn_every=0)
    assert M.cache_capacity(M.init_cache(none, B, 24, device="cpu"),
                            none) is None
    tok = torch.zeros((B, 1), dtype=torch.long)
    M.decode_step_layered(params, cfg, cache, 23, tok)
    for fn in (M.decode_step_layered, M.decode_step):
        with pytest.raises(ValueError, match="overflow"):
            fn(params, cfg, cache, 24, tok)


def test_cli_serves_zamba2(capsys):
    """``--arch zamba2-1.2b --smoke`` on the CPU, static and
    ``--continuous``: token ids printed, the same ids under ``--two-phase
    on``."""
    out = {}
    for extra in ([], ["--two-phase", "on"]):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--gen",
                    "4", *extra])
        text = capsys.readouterr().out
        out[tuple(extra)] = text[text.index("sample generations"):]
    assert out[()] == out[("--two-phase", "on")]
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                "--continuous", "--requests", "3", "--slots", "2"])
    assert "tok/s" in capsys.readouterr().out
