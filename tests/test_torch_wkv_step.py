"""W1, the one-token WKV step (``kernels/wkv/csrc/wkv_step.cu``), and
rwkv6-7b's decode through W1 and R1, on the CPU.

W1 runs only on the card.  Held here:

* its plain version (``ref.wkv_step_plain``, the CPU path of
  ``kernel.wkv_step``) against the reference's one-step recurrence
  (``rwkv_scan_ref`` at one position, and the decode branch of the
  reference's ``apply_rwkv_time``);
* its order, emulated in PyTorch (``ref.wkv_step_ordered``): within a
  stated tolerance of the plain step for ``y``, ``torch.equal`` for the
  state; row i at B in {1, 2, 3, 4, 8, 16} == the row alone;
* R1's order (``router.ref.router_logits_ordered``) at the two decay-LoRA
  shapes of rwkv6-7b's decode, rows == alone, and R1's tile rule there;
* the dispatch rule: a ``meta`` tensor never reaches W1's plain version
  (it raises at the missing compiler, or on a dtype the kernel lacks),
  and the wrapper calls the plain version only in its CPU branch;
* the step in place (``out=`` s0, the model's cache leaf): the same bits
  as a fresh state, no state allocated off the CPU, the cache's leaves
  kept by a decode step;
* ``router.ops.row_sum`` (R1 by a ones column, the decode norms' sum of
  squares): the library's sum on the CPU, R1 off it;
* the source keeps the emulated order (no FMA, every term ``__fmul_rn``
  then ``__fadd_rn``, t = 0 .. 63 in order);
* the model's decode on the CPU is the reference's arithmetic as before:
  ``apply_rwkv_time``'s decode branch ``torch.equal`` to the library's
  products and einsum written out.

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""
import ast
import dataclasses
import inspect
import os
import re
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as r_get_smoke
from repro.models import rwkv6 as R6

from repro_torch import configs
from repro_torch.kernels import build, tuning
from repro_torch.kernels.router import kernel as rk
from repro_torch.kernels.router import ops as rops
from repro_torch.kernels.router import ref as rref
from repro_torch.kernels.wkv import kernel as wk
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv import ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import rwkv6

torch.set_num_threads(2)

HD = 64
ROWS = (1, 2, 3, 4, 8, 16)
SMS = 132                       # an H100's SM count
SRC = os.path.join(os.path.dirname(wk.__file__), "csrc", "wkv_step.cu")
# rwkv6-7b's decay LoRA at decode: (B, d) @ (d, r), then (B, r) @ (r, d)
D_MODEL, LORA_R = 4096, 64


def _step_inputs(seed, B, nh, wmag=0.5):
    """r, k, v ~ N(0, 1); the decay e = exp(w) with w = max(-|N| wmag, -1)
    (the model's clamp); u ~ 0.1 N; the state s0 ~ N(0, 1) (a state after
    many steps is a sum of k v products of this size)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, nh, HD)).astype(np.float32)
               for _ in range(3))
    w = np.maximum(-np.abs(rng.standard_normal((B, nh, HD))) * wmag,
                   -1.0).astype(np.float32)
    u = (0.1 * rng.standard_normal((nh, HD))).astype(np.float32)
    s0 = rng.standard_normal((B, nh, HD, HD)).astype(np.float32)
    return r, k, v, w, u, s0


def _torch_step(r, k, v, w, u, s0):
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in (r, k, v, w, u, s0))
    return r, k, v, torch.exp(w), u, s0


def _layer0(cfg, g):
    """One layer of random mixer params (f32), unstacked."""
    return M._take(rwkv6.init_rwkv(g, cfg, n=1, dtype=torch.float32,
                                   device="cpu"), 0)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _close(got, want, rel, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


# ------------------------------------------------- plain vs the reference --

@pytest.mark.parametrize("wmag", [0.05, 1.0])
def test_plain_step_matches_reference_recurrence(wmag):
    """``wkv_step_plain`` against the reference's sequential recurrence at
    one position (``rwkv_scan_ref`` with the carried state): y and the
    state within 1e-5 of their largest |value| (64-term f32 sums in
    another order, and ``exp`` of two libraries, differ by a few ulps)."""
    r, k, v, w, u, s0 = _step_inputs(1, 3, 4, wmag)
    ry, rs = R6.rwkv_scan_ref(*(jnp.asarray(a[:, None]) for a in (r, k, v, w)),
                              jnp.asarray(u), s0=jnp.asarray(s0))
    y, s = ref.wkv_step_plain(*_torch_step(r, k, v, w, u, s0))
    _close(y, np.asarray(ry)[:, 0], 1e-5, "y")
    _close(s, np.asarray(rs), 1e-5, "state")


def test_plain_step_matches_reference_decode_branch():
    """The reference's ``apply_rwkv_time`` decode branch (its lines of the
    one-step recurrence) and the port's, which runs the step through
    ``ops.wkv_step`` and the decay LoRA through ``router_logits`` (both
    plain on the CPU), on one rwkv6-7b SMOKE layer with the same mixer
    params and the same carried state: the mixer output and the new state
    within 2e-5 of their largest |value| (test_torch_rwkv6's bound)."""
    rcfg = dataclasses.replace(r_get_smoke("rwkv6-7b"), policy="f32")
    cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    g = torch.Generator().manual_seed(0)
    p = _layer0(cfg, g)
    rp = _to_jax(p)
    rng = np.random.default_rng(2)
    nh = cfg.d_model // HD
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, nh, HD, HD)).astype(np.float32)
    shift = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    rout, rc = R6.apply_rwkv_time(
        rp, jnp.asarray(x), rcfg,
        cache={"wkv": jnp.asarray(s0), "shift_t": jnp.asarray(shift)})
    out, c = rwkv6.apply_rwkv_time(
        p, torch.from_numpy(x), cfg,
        cache={"wkv": torch.from_numpy(s0),
               "shift_t": torch.from_numpy(shift)})
    _close(out, np.asarray(rout), 2e-5, "time mix, decode")
    _close(c["wkv"], np.asarray(rc["wkv"]), 2e-5, "state, decode")


def test_cpu_decode_is_the_reference_arithmetic():
    """On the CPU the decode branch is the arithmetic it had before W1 and
    R1 took it on the card, bit for bit: the library's f32 LoRA products
    and the einsum step, written out here."""
    cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    g = torch.Generator().manual_seed(1)
    p = _layer0(cfg, g)
    rng = np.random.default_rng(3)
    B, d = 3, cfg.d_model
    nh = d // HD
    x = torch.from_numpy(rng.standard_normal((B, 1, d)).astype(np.float32))
    cache = {"wkv": torch.from_numpy(
        rng.standard_normal((B, nh, HD, HD)).astype(np.float32)),
        "shift_t": torch.from_numpy(
            rng.standard_normal((B, 1, d)).astype(np.float32))}
    s0 = cache["wkv"].clone()       # the step writes the state in place
    out, c = rwkv6.apply_rwkv_time(p, x, cfg, cache=cache)
    assert c["wkv"] is cache["wkv"]

    xx = cache["shift_t"]
    xr, xk, xv, xg, xw = (x + (xx - x) * p["mu"][i] for i in range(5))
    shape = (B, 1, nh, HD)
    r, k, v = ((a @ p[n]).reshape(shape).float() for a, n in
               ((xr, "w_r"), (xk, "w_k"), (xv, "w_v")))
    gate = F.silu(xg @ p["w_g"])
    lora = torch.tanh(xw.float() @ p["decay_lora_a"]) @ p["decay_lora_b"]
    w_log = torch.clamp(-torch.exp(p["decay_base"] + lora),
                        min=-1.0).reshape(shape)
    rt, kt, vt = r[:, 0], k[:, 0], v[:, 0]
    y1 = torch.einsum("bht,bhtd->bhd", rt, s0)
    bonus = (rt * p["bonus_u"] * kt).sum(-1)
    y = (y1 + bonus[..., None] * vt)[:, None]
    s = s0 * torch.exp(w_log[:, 0])[..., None] \
        + kt[..., :, None] * vt[..., None, :]
    y = L.rmsnorm(p["ln_x"], y.reshape(B, 1, d), cfg.norm_eps) * gate
    assert torch.equal(out, y @ p["w_o"])
    assert torch.equal(c["wkv"], s)


# -------------------------------------------------------- W1's order --

@pytest.mark.parametrize("wmag", [0.05, 1.0])
def test_ordered_step_matches_plain(wmag):
    """W1's order against the plain step: y within 1e-5 of the largest |y|
    (the same 64-term f32 sums in another order), the state
    ``torch.equal`` (one rounded product each, one rounded sum, in both)."""
    a = _torch_step(*_step_inputs(4, 5, 6, wmag))
    py, ps = ref.wkv_step_plain(*a)
    oy, os_ = ref.wkv_step_ordered(*a)
    _close(oy, py, 1e-5, "y")
    assert torch.equal(os_, ps)


def test_ordered_step_is_a_sequential_sum():
    """The emulation is the order the source states, one term at a time
    from +0: checked element by element in f32 numpy on a few (b, h, d)."""
    r, k, v, w, u, s0 = _step_inputs(5, 2, 3)
    oy, _ = ref.wkv_step_ordered(*_torch_step(r, k, v, w, u, s0))
    f = np.float32
    for b, h, d in ((0, 0, 0), (1, 2, 63), (0, 1, 17)):
        acc, bonus = f(0), f(0)
        for t in range(HD):
            acc = f(acc + f(r[b, h, t] * s0[b, h, t, d]))
            bonus = f(bonus + f(f(r[b, h, t] * u[h, t]) * k[b, h, t]))
        assert oy[b, h, d].item() == f(acc + f(bonus * v[b, h, d]))


def test_ordered_step_rows_equal_alone():
    """Row i of the emulated step at B in {1, 2, 3, 4, 8, 16} is
    ``torch.equal`` to the row stepped alone, y and state."""
    a = _torch_step(*_step_inputs(6, max(ROWS), 4))
    u = a[4]
    def rows(lo, hi):
        return [x[lo:hi] for x in a[:4]] + [u, a[5][lo:hi]]

    alone = [ref.wkv_step_ordered(*rows(i, i + 1)) for i in range(max(ROWS))]
    for B in ROWS:
        y, s = ref.wkv_step_ordered(*rows(0, B))
        for i in range(B):
            assert torch.equal(y[i:i + 1], alone[i][0]), (B, i)
            assert torch.equal(s[i:i + 1], alone[i][1]), (B, i)


# ------------------------------------------ R1 at the decay-LoRA shapes --

@pytest.mark.parametrize("d,E", [(D_MODEL, LORA_R), (LORA_R, D_MODEL)])
def test_router_order_at_lora_shapes_rows_equal_alone(d, E):
    """R1's order at the decay-LoRA shapes (f32 x and W): within 1e-5 of
    the library's f32 product's largest |value| (other order), and row i
    at B in {1, 2, 3, 4, 8, 16} ``torch.equal`` to the row alone."""
    rng = np.random.default_rng(d + E)
    x = torch.from_numpy(rng.standard_normal((max(ROWS), d)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((d, E)) * d ** -0.5).astype(
        np.float32))
    alone = [rref.router_logits_ordered(x[i:i + 1], w)
             for i in range(max(ROWS))]
    for B in ROWS:
        got = rref.router_logits_ordered(x[:B], w)
        _close(got, rref.router_logits_ref(x[:B], w), 1e-5, f"B {B}")
        for i in range(B):
            assert torch.equal(got[i:i + 1], alone[i]), (B, i)


@pytest.mark.parametrize("E", [LORA_R, D_MODEL])
def test_router_tiles_at_lora_shapes(E):
    """At the decode batches (1-16 tokens) the rule takes the few-token
    kernel with 2 experts a warp (E even) and 1-8 warps a block, a tile
    the source instantiates, and its grid covers every expert."""
    for T in ROWS:
        tiles = tuning.router_tiles(T, E, SMS)
        assert tiles.staged == 0 and tiles.experts == 2, (T, tiles)
        assert tiles.tokens in tuning.ROUTER_FEW_WARPS
        gx, gy = tuning.router_grid(T, E, tiles)
        assert gx * tiles.tokens >= T and gy * tiles.experts == E


# --------------------------------------------- decode norms in row order --

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_row_order_rmsnorm_is_the_mean_on_the_cpu(dt):
    """``rmsnorm(row_order=True)`` (the decode step's norms) is the
    library's mean on the CPU, bit for bit: the CPU results of decode do
    not change."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((5, 1, 96)).astype(
        np.float32)).to(dt)
    p = {"scale": torch.from_numpy(rng.standard_normal(96).astype(
        np.float32))}
    assert torch.equal(L.rmsnorm(p, x, 1e-6, row_order=True),
                       L.rmsnorm(p, x, 1e-6))


def test_row_order_rmsnorm_goes_to_r1_off_the_cpu(monkeypatch):
    """Off the CPU the sum of squares runs through ``router_logits`` (R1)
    by a (d, 1) column of ones: on ``meta`` tensors it reaches the launch
    (the missing compiler), never the library's mean; without
    ``row_order`` it never calls R1."""
    calls = []
    real = rk.router_logits

    def router(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    monkeypatch.setattr(rk, "router_logits", router)
    monkeypatch.setattr(rk.build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    rk._lib.cache_clear()
    x = _meta(3, 1, 128, dtype=torch.bfloat16)
    p = {"scale": _meta(128)}
    with pytest.raises(FileNotFoundError):
        L.rmsnorm(p, x, 1e-6, row_order=True)
    assert calls == [((3, 1, 128), (128, 1))]
    L.rmsnorm(p, x, 1e-6)
    assert len(calls) == 1
    rk._lib.cache_clear()


@pytest.mark.parametrize("d", [64, 4096, 5120])
def test_row_order_sum_of_squares_rows_equal_alone(d):
    """R1's order on x^2 by ones (what the card sums): within 1e-6 of the
    library's sum of squares (other order) and row i at B in {1, 2, 3, 4,
    8, 16} ``torch.equal`` to the row alone (the library's mean, by
    contrast, lays its threads out by the number of rows on the card)."""
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((max(ROWS), d)).astype(
        np.float32))
    ones = torch.ones((d, 1))
    sq = x * x
    alone = [rref.router_logits_ordered(sq[i:i + 1], ones)
             for i in range(max(ROWS))]
    for B in ROWS:
        got = rref.router_logits_ordered(sq[:B], ones)
        _close(got, sq[:B].sum(-1, keepdim=True), 1e-6, f"B {B}")
        for i in range(B):
            assert torch.equal(got[i:i + 1], alone[i]), (B, i)


def test_decode_norms_take_row_order_and_prefill_does_not(monkeypatch):
    """Every rmsnorm of a decode step (``_block``'s ln1 / ln2, the rwkv
    block's ln1 / ln2, ``ln_x``, the final norm) asks for row order, and
    no norm of a prefill does, on rwkv6-7b and llama4-scout SMOKE."""
    seen = []
    real = L.rmsnorm

    def norm(p, x, eps=1e-6, *, row_order=False):
        seen.append(row_order)
        return real(p, x, eps, row_order=row_order)

    monkeypatch.setattr(L, "rmsnorm", norm)
    for arch, per_layer in (("rwkv6-7b", 3), ("llama4-scout-17b-a16e", 2)):
        cfg = configs.get_smoke(arch)
        params = M.init_params(cfg, seed=0, device="cpu")
        prompts = torch.from_numpy(np.random.default_rng(4).integers(
            0, cfg.vocab_size, (2, 6)))
        seen.clear()
        logits, cache, pos = M.prefill_layered(params, prompts, cfg,
                                               max_seq=8)
        assert seen and not any(seen), arch
        seen.clear()
        tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
        M.decode_step_layered(params, cfg, cache, pos, tok)
        assert seen == [True] * (per_layer * cfg.n_repeats + 1), arch


# ------------------------------------------------- the dispatch rule --

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wkv_step_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    """A ``meta`` tensor goes to the kernel: with the plain version made to
    fail, ``wkv_step`` raises at the missing compiler (the launch), never
    in the plain version; a bf16 input or another head dim raises before
    it, and so does a shape mismatch."""
    def plain(*a, **kw):
        raise AssertionError("the plain WKV step ran")

    monkeypatch.setattr(wk, "wkv_step_plain", plain)
    monkeypatch.setattr(wk.build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    wk._step_lib.cache_clear()
    B, nh = 2, 3
    def vec(dt=torch.float32, hd=HD):
        return _meta(B, nh, hd, dtype=dt)

    u, s0 = _meta(nh, HD), _meta(B, nh, HD, HD)
    with pytest.raises(FileNotFoundError):
        wk.wkv_step(vec(), vec(), vec(), vec(), u, s0)
    with pytest.raises(FileNotFoundError):
        ops.wkv_step(vec(), vec(), vec(), vec(), u, s0)
    with pytest.raises(TypeError):
        wk.wkv_step(vec(torch.bfloat16), vec(), vec(), vec(), u, s0)
    with pytest.raises(ValueError):
        wk.wkv_step(vec(hd=32), vec(hd=32), vec(hd=32), vec(hd=32),
                    _meta(nh, 32), _meta(B, nh, 32, 32))
    with pytest.raises(ValueError):
        wk.wkv_step(vec(), vec(), vec(), vec(), u, _meta(B, nh, HD, 32))
    wk._step_lib.cache_clear()


def test_step_in_place_is_the_fresh_step():
    """``out=`` s0 (the model's cache leaf) gives the same y and state as a
    fresh state, ``torch.equal``, and returns ``out`` itself; an ``out`` of
    another shape raises."""
    a = _torch_step(*_step_inputs(8, 3, 2))
    y, s = wk.wkv_step(*a)
    s0 = a[5].clone()
    y2, s2 = ops.wkv_step(*a[:5], s0, out=s0)
    assert s2 is s0 and torch.equal(y2, y) and torch.equal(s0, s)
    with pytest.raises(ValueError):
        wk.wkv_step(*a, out=torch.empty(3, 2, HD, HD - 1))


def test_step_in_place_off_the_cpu_makes_no_state(monkeypatch):
    """Off the CPU (``meta`` tensors, a fake library) with ``out`` the
    wrapper launches once into ``out`` and allocates only y; without it,
    y and a fresh state; an ``out`` in bf16 raises before the launch."""
    calls = []
    lib = __import__("types").SimpleNamespace(
        wkv_step_launch=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(wk, "_step_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: __import__(
                            "types").SimpleNamespace(cuda_stream=7))
    made = []
    empty_like = torch.empty_like

    def count_like(t, *a, **kw):
        made.append(tuple(t.shape))
        return empty_like(t, *a, **kw)

    monkeypatch.setattr(torch, "empty_like", count_like)
    B, nh = 2, 3
    vecs = [_meta(B, nh, HD) for _ in range(4)]
    u, s0 = _meta(nh, HD), _meta(B, nh, HD, HD)
    _, s = wk.wkv_step(*vecs, u, s0, out=s0)
    assert s is s0 and made == [(B, nh, HD)] and len(calls) == 1
    made.clear()
    _, s = wk.wkv_step(*vecs, u, s0)
    assert s is not s0 and sorted(made) == [(B, nh, HD), (B, nh, HD, HD)]
    with pytest.raises(TypeError):
        wk.wkv_step(*vecs, u, s0, out=_meta(B, nh, HD, HD,
                                            dtype=torch.bfloat16))
    assert len(calls) == 2


def test_decode_steps_the_cache_state_in_place():
    """A decode step of rwkv6-7b SMOKE keeps each rwkv slot's ``wkv``
    leaf, and its storage, and writes the new state there: the cache after
    the step holds the same bits as a step on a copy of the cache."""
    cfg = configs.get_smoke("rwkv6-7b")
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 5)))
    logits, cache, pos = M.prefill_layered(params, prompts, cfg, max_seq=8)
    M.to_decode_dtypes(cfg, cache)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    copy = {"slots": [{k: v.clone() for k, v in slot.items()}
                      for slot in cache["slots"]]}
    leaves = [(slot["wkv"], slot["wkv"].data_ptr())
              for slot in cache["slots"]]
    got, _ = M.decode_step_layered(params, cfg, cache, pos, tok)
    want, _ = M.decode_step_layered(params, cfg, {**cache, **copy}, pos,
                                    tok)
    assert torch.equal(got, want)
    for slot, other, (leaf, ptr) in zip(cache["slots"], copy["slots"],
                                        leaves):
        assert slot["wkv"] is leaf and leaf.data_ptr() == ptr
        assert torch.equal(slot["wkv"], other["wkv"])


# --------------------------------------------- R1 as a row sum --

@pytest.mark.parametrize("d", [64, 4096, 5120])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_row_sum_is_the_library_sum_on_the_cpu(d, dt):
    """``router.ops.row_sum`` on the CPU is ``x.float().sum(-1)``, bit for
    bit, and divided by d it is the library's mean, bit for bit (what
    ``rmsnorm`` took before row order)."""
    rng = np.random.default_rng(d + 1)
    x = torch.from_numpy(rng.standard_normal((5, 1, d)).astype(
        np.float32)).to(dt)
    got = rops.row_sum(x)
    assert got.dtype == torch.float32 and got.shape == (5, 1, 1)
    assert torch.equal(got, x.float().sum(-1, keepdim=True))
    sq = x.float() * x.float()
    assert torch.equal(rops.row_sum(sq) / d, sq.mean(-1, keepdim=True))


def test_row_sum_off_the_cpu_is_r1_by_one_ones_column(monkeypatch):
    """Off the CPU ``row_sum`` is R1 (``router_logits``) of x by a (d, 1)
    column of ones, made once a (d, device) and reused; it never takes the
    library's sum."""
    calls = []

    def router(x, w):
        calls.append((tuple(x.shape), w))
        return _meta(*x.shape[:-1], w.shape[1])

    monkeypatch.setattr(rk, "router_logits", router)
    x = _meta(4, 1, 96)
    out = rops.row_sum(x)
    rops.row_sum(x)
    assert out.shape == (4, 1, 1)
    (s1, w1), (s2, w2) = calls
    assert s1 == s2 == (4, 1, 96) and w1 is w2
    assert w1.shape == (96, 1) and w1.dtype == torch.float32
    assert torch.equal(rops._ones_column(96, torch.device("cpu")),
                       torch.ones((96, 1)))


def _calls(fn, names):
    """(call name, the enclosing ``if`` tests) of each call of ``names`` in
    ``fn``'s source."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    found = []

    def walk(node, tests):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name in names:
                found.append((name, list(tests)))
        for child in ast.iter_child_nodes(node):
            walk(child, tests + [ast.unparse(node.test)]
                 if isinstance(node, ast.If) and child in node.body
                 else tests)

    walk(tree, [])
    return found


@pytest.mark.parametrize("fn,names,device_of", [
    (wk.wkv_step, {"wkv_step_plain", "wkv_step_ordered"}, "r"),
    (ops.wkv_step, {"wkv_step_plain", "wkv_step_ordered"}, None),
    (rwkv6.apply_rwkv_time, {"wkv_step_plain", "router_logits_ref",
                             "einsum"}, None),
])
def test_plain_step_is_reached_from_the_cpu_branch_only(fn, names,
                                                       device_of):
    """By inspection: ``wkv_step`` calls its plain version only inside
    ``if r.device.type == "cpu"``; ``ops.wkv_step`` and the model's mixer
    never call a plain version or an einsum themselves."""
    calls = _calls(fn, names)
    if device_of is None:
        assert calls == []
    else:
        assert calls and all(
            f"{device_of}.device.type == 'cpu'" in tests
            for _, tests in calls), calls


def test_decode_lora_goes_through_router_logits(monkeypatch):
    """The decode branch computes both decay-LoRA products through
    ``router_logits`` (R1 on the card) and the step through
    ``ops.wkv_step`` (W1), which writes the state into the cache's own
    leaf (``out=`` s0); the prefill branch calls neither."""
    seen = []
    real_r, real_s = rk.router_logits, ops.wkv_step

    def router(x, w):
        seen.append(("router", tuple(x.shape), tuple(w.shape)))
        return real_r(x, w)

    def step(*a, out=None):
        seen.append(("step", tuple(a[0].shape), out is a[5]))
        return real_s(*a, out=out)

    monkeypatch.setattr(rk, "router_logits", router)
    monkeypatch.setattr(ops, "wkv_step", step)
    cfg = dataclasses.replace(configs.get_smoke("rwkv6-7b"), policy="f32")
    g = torch.Generator().manual_seed(2)
    p = _layer0(cfg, g)
    d, nh = cfg.d_model, cfg.d_model // HD
    x = torch.randn((2, 5, d), generator=g)
    _, c = rwkv6.apply_rwkv_time(p, x, cfg, collect=True)
    assert seen == []
    rwkv6.apply_rwkv_time(p, x[:, :1], cfg, cache=c)
    assert seen == [("router", (2, 1, d), (d, rwkv6.LORA_R)),
                    ("router", (2, 1, rwkv6.LORA_R), (rwkv6.LORA_R, d)),
                    ("step", (2, nh, HD), True)]


# -------------------------------------------------------- the source --

def _code() -> str:
    return re.sub(r"//[^\n]*", "", open(SRC).read())


def test_source_keeps_the_emulated_order():
    """No FMA anywhere; every running sum and every state value is a
    ``__fadd_rn`` of ``__fmul_rn`` products; the sums start from +0 and
    run over t = 0 .. kHD - 1 with kHD 64; the source is a build target;
    the build asks for no fast math."""
    code = _code()
    assert re.search(r"fma", code, re.IGNORECASE) is None
    assert re.findall(r"constexpr int kHD = (\d+);", code) == ["64"]
    assert "float acc = 0.f, bonus = 0.f;" in code
    assert "acc = __fadd_rn(acc, __fmul_rn(sr[t], col[t]));" in code
    assert "bonus = __fadd_rn(bonus, __fmul_rn(sru[t], sk[t]));" in code
    assert "sru[d] = __fmul_rn(rd, u[h * kHD + d]);" in code
    assert re.search(r"S1\[t \* kHD \+ d\] = __fadd_rn\(__fmul_rn\(col\[t\], "
                     r"se\[t\]\),\s*__fmul_rn\(sk\[t\], vd\)\);", code)
    assert "y[o + d] = __fadd_rn(acc, __fmul_rn(bonus, vd));" in code
    assert code.count("for (int t = 0; t < kHD; ++t)") == 3
    assert build.SOURCES["wkv_step"] == __import__("pathlib").Path(SRC)
    assert not any("fast" in f or "fmad" in f for f in build.NVCC_FLAGS)
    assert "wkv_step" in __import__("repro_torch.kernels",
                                    fromlist=["x"]).launch_counters()


def test_binding_matches_the_launcher():
    """The wrapper's argument types are the launcher's: eight pointers
    (r, k, v, e, u, s0, y, s1), three ints (B, nh, hd), the stream."""
    sig = re.search(r"int wkv_step_launch\(([^)]*)\)", _code()).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "r", "k", "v", "e", "u", "s0", "y", "s1", "B", "nh", "hd", "stream"]
    assert sum("*" in p for p in params) == 9 and sum(
        p.startswith("int ") for p in params) == 3
    src = inspect.getsource(wk._step_lib)
    assert "[_P] * 8 + [_I] * 3 + [_P]" in src
