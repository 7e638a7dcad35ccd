"""The port's kernels under autograd, on the CPU.

A CUDA kernel writes its output through a raw pointer, so a wrapper that
launched it under autograd would hand back a tensor with no ``grad_fn``
and drop the gradients behind it.  Three kernels of the train path carry a
backward instead, each an ``autograd.Function``; these tests hold them as
the existing tests fake the card:

* ``layers.ChunkedAttention`` (the chunked prefill's narrow branch, where
  ``torch.bmm(..., out_dtype=float32)`` has no derivative) taken on the
  CPU with ``bmm``'s ``out_dtype`` computed as an f32 product of the
  widened operands: its gradients against plain autograd of the wide loop
  and against ``jax.grad`` of the reference's ``chunked_attention``;
* ``layers.FlashFwdChunkedBwd`` (``impl="kernel_sharded"``): its forward
  against the reference's flash kernel in interpret mode, its gradients
  against ``jax.grad`` of the reference's chunked attention, the
  reference's own definition of that path's backward;
* R1's ``router.kernel.RouterLogits`` and K7's ``wkv.ops.WkvState`` with
  the plain forward standing in for the kernel, by
  ``torch.autograd.gradcheck`` in f64;

and every other wrapper (K2, K3 called directly, K4m, K4s, K5, K6a, K6b, K7
called directly, D1, W1, M1, and the MoE's bcsr dispatch) raises when grad
mode is on and an input requires grad, on ``meta`` tensors (the card's
branch), instead of detaching.  Tolerances are stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as RFK
from repro.models import layers as RL

from repro_torch import configs
from repro_torch.core.stencils import STENCILS
from repro_torch.kernels import build, tuning
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.router import kernel as rk
from repro_torch.kernels.router.ref import router_logits_ref
from repro_torch.kernels.spmm import kernel as sk
from repro_torch.kernels.spmspm import kernel as pk
from repro_torch.kernels.ssd import kernel as mk
from repro_torch.kernels.stencil import kernel as tk
from repro_torch.kernels.wkv import kernel as wk
from repro_torch.kernels.wkv import ops as wops
from repro_torch.kernels.wkv.ref import wkv_chunked_plain
from repro_torch.models import layers as L
from repro_torch.models import moe

torch.set_num_threads(2)
F32, BF16, F64 = torch.float32, torch.bfloat16, torch.float64


def _qkv(seed, S=37, hd=16, Hq=4, Hkv=2, dt=F32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in
            ((2, Hq, S, hd), (2, Hkv, S, hd), (2, Hkv, S, hd))], dt


def _leaves(arrays, dt):
    return [torch.from_numpy(a).to(dt).requires_grad_() for a in arrays]


def _rel(got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _reference_grads(arrays, dt, g, window, fn=RL.chunked_attention):
    """jax.grad of sum(fn(q, k, v) * g) at the reference's dtype."""
    jdt = jnp.bfloat16 if dt == BF16 else jnp.float32
    q, k, v = (jnp.asarray(a, jdt) for a in arrays)
    grads = jax.grad(lambda q, k, v: jnp.sum(
        fn(q, k, v, causal=True, window=window).astype(jnp.float32) * g),
        argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


@pytest.fixture
def fake_bmm(monkeypatch):
    """The narrow branch on the CPU: ``bmm``'s ``out_dtype`` as an f32
    product of the widened operands (a narrow product is exact in f32);
    counts the narrow calls."""
    bmm = torch.bmm
    calls = []

    def bmm_out(a, b, *, out_dtype=None):
        if out_dtype is None:
            return bmm(a, b)
        assert a.dtype == b.dtype and out_dtype == F32
        calls.append(1)
        return bmm(a.float(), b.float())

    monkeypatch.setattr(L, "_narrow_operands", lambda t: True)
    monkeypatch.setattr(torch, "bmm", bmm_out)
    return calls


# the narrow branch's gradients: f32 operands agree with plain autograd of
# the wide loop and with the reference to 1e-5 of the largest |grad| (the
# same f32 products, summed in another order); bf16 operands to 2^-7 of it
# (the gradients are rounded to bf16 on both sides, and the reference's
# scan also sums q's gradient in bf16 from chunk to chunk)
NARROW_TOL = {F32: 1e-5, BF16: 2.0 ** -7}


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("window", [None, 11])
def test_chunked_function_narrow_branch_gradients(fake_bmm, dt, window):
    arrays, dt = _qkv(3, dt=dt)
    g = np.random.default_rng(4).normal(size=(2, 4, 37, 16)).astype(
        np.float32)
    gt = torch.from_numpy(g)
    q, k, v = _leaves(arrays, dt)
    out = L.chunked_attention(q, k, v, window=window, chunk=16)
    assert out.grad_fn is not None and "ChunkedAttention" in str(
        type(out.grad_fn))
    n_forward = len(fake_bmm)
    assert n_forward == 2 * 3                       # 2 products x 3 chunks
    got = torch.autograd.grad((out.float() * gt).sum(), (q, k, v))
    assert len(fake_bmm) == n_forward + 3           # the scores, recomputed
    assert [t.dtype for t in got] == [dt] * 3
    # plain autograd of the wide loop on the same inputs
    L._narrow_operands, narrow = (lambda t: False), L._narrow_operands
    try:
        q2, k2, v2 = _leaves(arrays, dt)
        wide = L.chunked_attention(q2, k2, v2, window=window, chunk=16)
        want = torch.autograd.grad((wide.float() * gt).sum(), (q2, k2, v2))
    finally:
        L._narrow_operands = narrow
    assert torch.equal(out, wide) or dt == BF16
    ref = _reference_grads(arrays, dt, g, window)
    for a, b, r in zip(got, want, ref):
        assert _rel(a.float(), b.float()) <= NARROW_TOL[dt]
        assert _rel(a.float(), r) <= NARROW_TOL[dt]


def test_chunked_function_is_off_the_cpu_path():
    """On the CPU (no faked ``bmm``) the chunked path is the wide loop under
    plain autograd, with no ``Function`` node."""
    arrays, dt = _qkv(5)
    q, k, v = _leaves(arrays, dt)
    out = L.chunked_attention(q, k, v, chunk=16)
    assert "ChunkedAttention" not in str(type(out.grad_fn))


@pytest.mark.parametrize("window", [None, 24])
def test_kernel_sharded_forward_is_k3_and_backward_is_chunked(window):
    """``FlashFwdChunkedBwd`` at S 64 (f32): the forward within 1e-5 of the
    reference's flash kernel in interpret mode at the port's tiles, the
    gradients within 1e-5 of the largest |grad| of ``jax.grad`` of the
    reference's ``chunked_attention`` (what its custom VJP takes)."""
    arrays, dt = _qkv(6, S=64)
    q, k, v = _leaves(arrays, dt)
    out = L.FlashFwdChunkedBwd.apply(q, k, v, window)
    bq, bk = tuning.flash_tiles(64, 64, 16, F32, torch.device("cpu"))
    want = RFK.flash_attention(*(jnp.asarray(a) for a in arrays),
                               causal=True, window=window, bq=bq, bk=bk,
                               interpret=True)
    assert _rel(out.detach(), want) <= 1e-5
    g = np.random.default_rng(7).normal(size=out.shape).astype(np.float32)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), (q, k, v))
    for a, r in zip(got, _reference_grads(arrays, dt, g, window)):
        assert _rel(a, r) <= 1e-5


def test_kernel_sharded_layer_matches_reference_chunked_grads():
    """``apply_attention(impl="kernel_sharded")`` inside a layer (qwen3-1.7b
    SMOKE, f32): the gradients of its weights within 1e-5 of the largest
    |grad| of the reference's chunked layer (the reference's own
    kernel_sharded path does not run on the CPU)."""
    import dataclasses
    from repro.configs import get_smoke
    from repro_torch.interop import params_from_jax
    rcfg = dataclasses.replace(get_smoke("qwen3-1.7b"), policy="f32")
    cfg = dataclasses.replace(configs.get_smoke("qwen3-1.7b"), policy="f32")
    rp = jax.device_get(RL.init_attention(jax.random.PRNGKey(1), rcfg))
    x = np.random.default_rng(8).normal(size=(2, 40, 64)).astype(np.float32)
    p = params_from_jax(rp, cfg, device="cpu", train=True)
    p = {k: v.requires_grad_() if isinstance(v, torch.Tensor) else v
         for k, v in p.items()}
    out, _ = L.apply_attention(p, torch.from_numpy(x), cfg,
                               impl="kernel_sharded")
    names = ("wq", "wk", "wv", "wo")
    got = torch.autograd.grad(out.square().sum(), [p[n] for n in names])
    want = jax.grad(lambda rp: jnp.sum(jnp.square(RL.apply_attention(
        rp, jnp.asarray(x), rcfg, impl="chunked")[0])))(rp)
    for name, a in zip(names, got):
        assert _rel(a, want[name]) <= 1e-5, name


# ---------------------------------------------------------- R1 and K7 ------

def test_router_function_gradcheck(monkeypatch):
    """``RouterLogits`` with the plain product (in f64) standing in for R1:
    ``gradcheck`` in f64 of dx and dW."""
    monkeypatch.setattr(rk, "_forward", lambda x, w: x @ w)
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(2, 3, 8))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(8, 5))).requires_grad_()
    assert torch.autograd.gradcheck(rk.RouterLogits.apply, (x, w))


def test_router_function_dtypes_and_values(monkeypatch):
    """x bf16, W f32 (the model's): dx comes back bf16 and dW f32, equal to
    plain autograd of the reference's product (``router_logits_ref``, x
    widened to f32) to 1e-6 of the largest |grad|."""
    monkeypatch.setattr(rk, "_forward", router_logits_ref)
    rng = np.random.default_rng(10)
    xa = rng.normal(size=(4, 6, 32)).astype(np.float32)
    wa = rng.normal(size=(32, 4)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(4, 6, 4)).astype(np.float32))
    x = torch.from_numpy(xa).to(BF16).requires_grad_()
    w = torch.from_numpy(wa).requires_grad_()
    dx, dw = torch.autograd.grad((rk.RouterLogits.apply(x, w) * g).sum(),
                                 (x, w))
    assert dx.dtype == BF16 and dw.dtype == F32
    x2 = torch.from_numpy(xa).to(BF16).requires_grad_()
    w2 = torch.from_numpy(wa).requires_grad_()
    ex, ew = torch.autograd.grad((router_logits_ref(x2, w2) * g).sum(),
                                 (x2, w2))
    assert _rel(dx.float(), ex.float()) <= 1e-6
    assert _rel(dw, ew) <= 1e-6


def _wkv_inputs(seed, T=20, nh=2, hd=4, dt=F64):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.normal(size=(1, T, nh, hd))).to(dt)
               for _ in range(3))
    w = torch.from_numpy(-rng.uniform(0.05, 0.9, size=(1, T, nh, hd))).to(dt)
    u = torch.from_numpy(rng.normal(size=(nh, hd))).to(dt)
    return [t.requires_grad_() for t in (r, k, v, w, u)]


@pytest.mark.parametrize("use_state", [False, True])
def test_wkv_function_gradcheck(monkeypatch, use_state):
    """``WkvState`` with the plain chunked form (f64) standing in for K7:
    ``gradcheck`` in f64 of r, k, v, the decay and the bonus, through y
    alone (no gradient into the unused state) or y and the state."""
    monkeypatch.setattr(wops, "_forward", wkv_chunked_plain)
    ins = _wkv_inputs(11, T=16)

    def fn(*a):
        y, s = wops.WkvState.apply(*a, 8)
        return (y, s) if use_state else y

    assert torch.autograd.gradcheck(fn, ins)


def test_wkv_function_matches_plain_autograd(monkeypatch):
    """Through ``wkv_state``'s card branch (padding T 20 to 24 at chunk 8)
    with the plain forward standing in for K7, f32: y ``torch.equal`` to
    the plain version's, and the gradients of r, k, v, w, u within 1e-6 of
    the largest |grad| of plain autograd through it."""
    monkeypatch.setattr(wops, "_forward", wkv_chunked_plain)
    ins = _wkv_inputs(12, dt=F32)
    r, k, v, w, u = ins
    T = r.shape[1]
    pad = (-T) % 8
    padded = [torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
              for t in (r, k, v, w)]
    y, s = wops.WkvState.apply(*(t.contiguous() for t in padded), u, 8)
    y = y[:, :T]
    g = torch.from_numpy(np.random.default_rng(13).normal(
        size=y.shape).astype(np.float32))
    got = torch.autograd.grad((y * g).sum(), ins)
    ins2 = _wkv_inputs(12, dt=F32)
    y2, _ = wkv_chunked_plain(*ins2, 8)
    assert torch.equal(y.detach(), y2.detach())
    want = torch.autograd.grad((y2 * g).sum(), ins2)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6


# ------------------------------------------- every other wrapper refuses --

def _meta(*shape, dtype=F32, grad=False):
    t = torch.empty(shape, dtype=dtype, device="meta")
    return t.requires_grad_() if grad else t


def _i32(*shape):
    return _meta(*shape, dtype=torch.int32)


def _calls(grad: bool):
    """(name, call) of every CUDA wrapper without a backward, on meta
    tensors whose float operands require grad where ``grad``."""
    m = lambda *s, dtype=F32: _meta(*s, dtype=dtype, grad=grad)  # noqa
    j3d = next(s for s in STENCILS.values() if s.ndim == 3)
    j2d = next(s for s in STENCILS.values() if s.ndim == 2)
    return {
        "spmm_bcsr (K2)": lambda: sk.spmm_bcsr(
            _i32(3), _i32(4), m(1, 4, 8, 8), m(1, 16, 64)),
        "flash_attention (K3)": lambda: fk.flash_attention(
            m(1, 2, 64, 64), m(1, 2, 64, 64), m(1, 2, 64, 64), bq=64, bk=64),
        "flash_attention_masked (K4m)": lambda: fk.flash_attention_masked(
            m(1, 2, 64, 64), m(1, 2, 64, 64), m(1, 2, 64, 64),
            np.zeros((1, 1), np.int32), skv=64),
        "flash_attention_sparse (K4s)": lambda: fk.flash_attention_sparse(
            m(1, 2, 64, 64), m(1, 2, 64, 64), m(1, 2, 64, 64),
            np.zeros(1, np.int32), np.zeros(1, np.int32),
            np.zeros(1, np.int32), skv=64, bq=64, bk=64),
        "spmspm_ell (K5)": lambda: pk.spmspm_ell(
            _i32(4, 3), m(4, 3), _i32(5, 3), m(5, 3)),
        "stencil_2d (K6a)": lambda: tk.stencil_2d(
            m(*(16 + 2 * j2d.radius,) * 2), j2d),
        "stencil_3d (K6b)": lambda: tk.stencil_3d(
            m(*(16 + 2 * j3d.radius,) * 3), j3d),
        "wkv_kernel (K7 alone)": lambda: wk.wkv_kernel(
            m(1, 128, 1, 64), m(1, 128, 1, 64), m(1, 128, 1, 64),
            m(1, 128, 1, 64), m(1, 64)),
        "decode_attention (D1)": lambda: fk.decode_attention(
            m(2, 4, 1, 64), m(2, 2, 8, 64), m(2, 2, 8, 64), kv_len=3),
        "wkv_step (W1)": lambda: wk.wkv_step(
            m(2, 1, 64), m(2, 1, 64), m(2, 1, 64), m(2, 1, 64), m(1, 64),
            m(2, 1, 64, 64)),
        "ssd_step (M1)": lambda: mk.ssd_step(
            m(2, 128), m(2, 64), m(2, 64), m(2, 128), m(2, 2), m(2), m(2),
            m(2), m(2, 2, 64, 64)),
    }


@pytest.fixture
def no_nvcc(monkeypatch):
    """Past its checks a wrapper's first launch builds its library: make
    that raise ``FileNotFoundError``, as on a host without the compiler."""
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    for lib in (sk._lib, fk._lib, fk._decode_lib, pk._lib, tk._lib, wk._lib,
                wk._step_lib, mk._lib):
        lib.cache_clear()
    yield
    for lib in (sk._lib, fk._lib, fk._decode_lib, pk._lib, tk._lib, wk._lib,
                wk._step_lib, mk._lib):
        lib.cache_clear()


@pytest.mark.parametrize("name", list(_calls(False)))
def test_wrapper_without_backward_refuses_grad(no_nvcc, name):
    """Under grad, with an input that requires grad: ``RuntimeError``
    naming the kernel, before any build or launch; under ``no_grad`` the
    same call passes the refusal (and stops at the missing compiler or a
    check of the meta tensors' layout)."""
    with pytest.raises(RuntimeError, match="no backward"):
        _calls(True)[name]()
    with torch.no_grad():
        with pytest.raises(Exception) as err:
            _calls(True)[name]()
    assert "no backward" not in str(err.value)


def test_wrappers_with_a_backward_launch_inside_their_function(no_nvcc,
                                                               monkeypatch):
    """R1 and K7 under grad on meta tensors do not refuse: from inside
    their ``Function`` they reach R1's launch (the missing compiler) and
    K7's device check (which takes CUDA tensors only)."""
    rk._lib.cache_clear()
    monkeypatch.setattr(rk, "_sms", lambda index: 132)
    with pytest.raises(FileNotFoundError):
        rk.router_logits(_meta(2, 3, 64, dtype=BF16, grad=True),
                         _meta(64, 16, grad=True))
    with pytest.raises(ValueError, match="tensors on meta"):
        wops.wkv_state(*(_meta(1, 100, 1, 64, grad=True) for _ in range(4)),
                       _meta(1, 64, grad=True), chunk=128)
    rk._lib.cache_clear()


def test_moe_bcsr_refuses_grad_and_gather_carries_it():
    """``apply_moe`` on llama4-scout SMOKE (f32): with an input that
    requires grad the bcsr dispatch raises; the gather dispatch carries
    gradients to x, the router and every expert weight."""
    import dataclasses
    from repro_torch.models import model as M
    cfg = dataclasses.replace(configs.get_smoke("llama4-scout-17b-a16e"),
                              policy="f32")
    p = M.init_params(cfg, device="cpu", param_dtype=F32)["blocks"][0]
    p = M._take(p, 0)["ffn"]
    x = torch.from_numpy(np.random.default_rng(14).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        moe.apply_moe(p, x, cfg, dispatch="bcsr")
    leaves = [p["router"], *p["experts"].values()]
    leaves = [t.detach().requires_grad_() for t in leaves]
    q = {**p, "router": leaves[0],
         "experts": dict(zip(p["experts"], leaves[1:]))}
    out, _ = moe.apply_moe(q, x, cfg, dispatch="gather")
    grads = torch.autograd.grad(out.square().sum(), [x, *leaves])
    assert all(g is not None and g.abs().sum() > 0 for g in grads)
