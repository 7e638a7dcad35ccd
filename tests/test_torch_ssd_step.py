"""M1, a Mamba-2 layer's whole decode step (``kernels/ssd/csrc/ssd_step.cu``),
on the CPU.

The kernel runs only on the card; here its plain forms are held:

* ``ref.ssd_step_plain`` (the SSD recurrence alone) against the
  reference's decode branch (``src/repro/models/mamba2.py:144-147``, its
  einsums in jax), within 1e-6 of the largest |value|;
* ``ref.ssd_step_ordered`` (M1's order: the state as plain, y summed over
  s = 0, 1, ... from +0): its state ``torch.equal`` to plain, y within
  1e-6 of plain and equal to a sequential sum written out scalar by scalar,
  rows at B 1-16 ``torch.equal`` to the row alone;
* ``ref.mamba_step_plain`` (the whole step, from the conv's output to the
  gated norm's input: the CPU path of ``kernel.ssd_step``) ``torch.equal``
  to ``apply_mamba``'s decode arithmetic as it ran before M1 took the whole
  step, written out here op for op, in bf16 and f32 at both instances and
  B 1-8, with nonzero ``dt_bias`` / ``d_skip`` and a dt past softplus's
  threshold; and within 1e-5 of the reference's decode lines in jax;
* ``ref.mamba_step_ordered``: its state ``torch.equal`` to plain, its
  output within one ulp (bf16) or 1e-5 (f32) of plain's, rows at B 1-8
  ``torch.equal`` to the row alone (at 64 heads a row: whole vectors of
  the CPU's elementwise kernels);
* the wrapper: the step in place (``out=`` the state) on views of a
  conv output and a projection as they lie; the refusal of a shape
  without an instance, a dtype, a strided row, a misaligned state and
  mismatched shapes on a tensor off the CPU; the kernel reached (a fake
  library, the rows' strides passed, no copy) and never the plain version
  off the CPU, and its count; ``apply_mamba``'s decode calls it once, on
  the views, in place into the cache; the source's order and its binding.
"""
import inspect
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.kernels import build
from repro_torch.kernels.ssd import kernel as mk
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import (mamba_step_ordered,
                                         mamba_step_plain, ssd_step_ordered,
                                         ssd_step_plain)
from repro_torch.models import mamba2
from repro_torch.models import model as M

SRC = str(pathlib.Path(mk.__file__).parent / "csrc" / "ssd_step.cu")
SHAPES = [(64, 64), (16, 16)]       # (hd, ns): zamba2-1.2b CONFIG, SMOKE
DTYPES = [torch.bfloat16, torch.float32]
NH = 4
# heads a row where a row is held alone on the CPU: zamba2-1.2b's
ROW_HEADS = 64
REL = 1e-6


def _inputs(B, hd, ns, seed=0, nh=NH):
    """x, e, b, c, h0 (f32) of a step: e in (0, 1], the decay a state sees
    at the small config's dt."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    e = torch.from_numpy(rng.uniform(0.05, 1.0, (B, nh)).astype(np.float32))
    return t(B, nh, hd), e, t(B, ns), t(B, ns), t(B, nh, hd, ns)


def _close(got, want, what, rel=REL):
    big = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * big, f"{what}: {err} > {rel} x {big}"


def _step_inputs(B, hd, ns, dtype, seed=0, nh=NH):
    """(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0) of a whole step as
    ``apply_mamba`` hands them over: xs, b, c views of one conv output row
    (B, d_in + 2 ns), z and dt views of one projection row (B, 2 d_in + 2
    ns + nh), in ``dtype``; ``dt + dt_bias`` past softplus's threshold of
    20 at head 0 and far below 0 at head 1; the layer's f32 ``a_log``
    (the reference's init plus noise), nonzero ``dt_bias`` and ``d_skip``;
    an f32 state."""
    rng = np.random.default_rng(seed)
    d_in = nh * hd
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    conv = f(rng.normal(size=(B, d_in + 2 * ns))).to(dtype)
    proj = rng.normal(size=(B, 2 * d_in + 2 * ns + nh))
    proj[:, -nh:] *= 2.0
    proj[:, -nh] = 24.0 + rng.uniform(0, 4, B)
    proj[:, -nh + 1] = -30.0
    proj = f(proj).to(dtype)
    xs, b, c = conv[:, :d_in], conv[:, d_in:d_in + ns], conv[:, d_in + ns:]
    z, dt = proj[:, d_in + 2 * ns:2 * d_in + 2 * ns], proj[:, -nh:]
    a_log = f(np.log(np.linspace(1.0, 16.0, nh)) + rng.normal(0, 0.1, nh))
    dt_bias = f(rng.normal(0, 0.5, nh))
    d_skip = f(rng.normal(1.0, 0.3, nh))
    h0 = f(rng.normal(size=(B, nh, hd, ns)))
    return xs, b, c, z, dt, a_log, dt_bias, d_skip, h0


def _parent_decode(xs, b, c, z, dt, a_log, dt_bias, d_skip, h0):
    """``apply_mamba``'s decode arithmetic before M1 took the whole step,
    at T = 1, with the SSD step's wrapper making its inputs f32 and
    contiguous; returns (its gated norm's input (B, d_in), the state)."""
    B, d_in = xs.shape
    nh = dt.shape[-1]
    hd, T = d_in // nh, 1
    xs, Bv, Cv, z, dt = (t[:, None] for t in (xs, b, c, z, dt))
    cd = xs.dtype
    dt = F.softplus(dt.float() + dt_bias)                       # (B, T, nh)
    a_log = -torch.exp(a_log) * dt
    xh = xs.float().reshape(B, T, nh, hd) * dt[..., None]
    y, h = ssd_step_plain(*(t.float().contiguous() for t in (
        xh[:, 0], torch.exp(a_log[:, 0]), Bv[:, 0], Cv[:, 0], h0)))
    y = y[:, None]
    y = y + d_skip[:, None] * xs.float().reshape(B, T, nh, hd)
    y = y.reshape(B, T, d_in).to(cd)
    return (y * F.silu(z))[:, 0], h


def _rows(a, lo, hi):
    """Rows [lo, hi) of a whole step's inputs: the batched ones sliced,
    the layer's a_log / dt_bias / d_skip as they are."""
    return tuple(t[lo:hi] if i in (0, 1, 2, 3, 4, 8) else t
                 for i, t in enumerate(a))


@pytest.mark.parametrize("hd,ns", SHAPES)
def test_plain_step_matches_reference_decode_branch(hd, ns):
    """The plain step is the reference's: ``h0 e + einsum(x, B)`` and
    ``einsum(C, h')``, computed in jax on the same numpy inputs."""
    x, e, b, c, h0 = _inputs(3, hd, ns)
    y, h = ssd_step_plain(x, e, b, c, h0)
    jx, je, jb, jc, jh = (jnp.asarray(t.numpy()) for t in (x, e, b, c, h0))
    hb = jnp.einsum("bthd,bts->bhds", jx[:, None], jb[:, None])
    wh = jh * je[:, :, None, None] + hb
    wy = jnp.einsum("bts,bhds->bthd", jc[:, None], wh)[:, 0]
    _close(h, torch.tensor(np.asarray(wh)), "state")
    _close(y, torch.tensor(np.asarray(wy)), "y")


@pytest.mark.parametrize("hd,ns", SHAPES)
def test_ordered_step_state_is_plain_and_y_close(hd, ns):
    """M1's order: the state ``torch.equal`` to plain (one rounded product
    each and one rounded sum), y within 1e-6 of plain's library sum."""
    args = _inputs(5, hd, ns, seed=1)
    y, h = ssd_step_ordered(*args)
    py, ph = ssd_step_plain(*args)
    assert torch.equal(h, ph)
    _close(y, py, "ordered y vs plain")


def test_ordered_step_is_a_sequential_sum():
    """y[b, h, d] == +0 + C[0] h'[d, 0] + C[1] h'[d, 1] + ... in f32, every
    product and sum rounded on its own, written out with numpy scalars."""
    x, e, b, c, h0 = _inputs(2, 16, 16, seed=2, nh=2)
    y, h = ssd_step_ordered(x, e, b, c, h0)
    hn, cn = h.numpy(), c.numpy()
    for bi, hi, d in ((0, 0, 0), (1, 1, 15), (0, 1, 7)):
        acc = np.float32(0.0)
        for s in range(16):
            acc = np.float32(acc + np.float32(cn[bi, s] * hn[bi, hi, d, s]))
        assert y[bi, hi, d].item() == acc


@pytest.mark.parametrize("hd,ns", SHAPES)
def test_ordered_step_rows_equal_alone(hd, ns):
    """Row i of a batch of 1-16 rows ``torch.equal`` to row i alone, y and
    state: the order is a function of the head alone."""
    args = _inputs(16, hd, ns, seed=3)
    for B in (1, 2, 3, 4, 8, 16):
        y, h = ssd_step_ordered(*(t[:B] for t in args))
        for i in {0, B // 2, B - 1}:
            yi, hi = ssd_step_ordered(*(t[i:i + 1] for t in args))
            assert torch.equal(y[i:i + 1], yi) and torch.equal(h[i:i + 1], hi)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,ns", SHAPES)
def test_mamba_step_plain_is_the_parent_decode_arithmetic(dtype, hd, ns):
    """The whole step's plain version is ``torch.equal`` to the decode
    branch's op sequence it replaces (softplus past its threshold and far
    below 0 included), output and state, at B 1-8."""
    for B in (1, 2, 3, 5, 8):
        a = _step_inputs(B, hd, ns, dtype, seed=10 + B)
        y, h = mamba_step_plain(*a)
        wy, wh = _parent_decode(*a)
        assert y.dtype == dtype and tuple(y.shape) == (B, NH * hd)
        assert torch.equal(y, wy) and torch.equal(h, wh)
        assert torch.isfinite(y.float()).all()


@pytest.mark.parametrize("hd,ns", SHAPES)
def test_mamba_step_matches_reference_decode_lines(hd, ns):
    """f32: the whole plain step within 1e-5 of the reference's decode
    lines (softplus, the decay, x dt, the einsums, the skip, the gate),
    computed in jax on the same numpy inputs."""
    a = _step_inputs(3, hd, ns, torch.float32, seed=4)
    y, h = mamba_step_plain(*a)
    xs, Bv, Cv, z, dt, a_log, dt_bias, d_skip, h0 = (
        jnp.asarray(t.contiguous().numpy()) for t in a)
    B, d_in = xs.shape
    dtp = jax.nn.softplus(dt + dt_bias)
    xh = xs.reshape(B, NH, hd) * dtp[..., None]
    wh = (h0 * jnp.exp(-jnp.exp(a_log)[None] * dtp)[:, :, None, None]
          + jnp.einsum("bhd,bs->bhds", xh, Bv))
    wy = (jnp.einsum("bs,bhds->bhd", Cv, wh)
          + d_skip[None, :, None] * xs.reshape(B, NH, hd))
    wy = wy.reshape(B, d_in) * jax.nn.silu(z)
    _close(h, torch.tensor(np.asarray(wh)), "state", 1e-5)
    _close(y, torch.tensor(np.asarray(wy)), "gated output", 1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hd,ns", SHAPES)
def test_mamba_step_ordered_is_plain_state_and_rows_alone(dtype, hd, ns):
    """M1's order over the whole step: the state ``torch.equal`` to plain,
    the output within one ulp of plain's largest |value| (bf16; f32 within
    1e-5 of it: the same sums in another order), and each row at B 1-8
    ``torch.equal`` to the row alone.  At zamba2-1.2b's 64 heads a row:
    the CPU's exp, softplus and silu round an element by where it falls in
    its tensor (a whole vector of the CPU's width or the scalar tail), so
    a row is held alone here where its elements fill whole vectors either
    way; the card's elementwise kernels have no such tail, and
    ``chip_smoke.py`` holds the kernel's rows alone at every instance."""
    a = _step_inputs(8, hd, ns, dtype, seed=5, nh=ROW_HEADS)
    y, h = mamba_step_ordered(*a)
    py, ph = mamba_step_plain(*a)
    assert torch.equal(h, ph)
    big = py.float().abs().max().item()
    tol = (1e-5 * big if dtype == torch.float32
           else 2.0 ** np.floor(np.log2(big)) * torch.finfo(dtype).eps)
    assert (y.float() - py.float()).abs().max().item() <= tol
    alone = [mamba_step_ordered(*_rows(a, i, i + 1)) for i in range(8)]
    for B in (1, 2, 3, 4, 8):
        yb, hb = mamba_step_ordered(*_rows(a, 0, B))
        for i in range(B):
            assert torch.equal(yb[i:i + 1], alone[i][0])
            assert torch.equal(hb[i:i + 1], alone[i][1])


def test_step_in_place_is_the_fresh_step():
    """``out=`` the state: the same output and the same state bits as a
    step into a fresh tensor, written into h0's own storage; the rows'
    views as they lie give the bits of contiguous copies."""
    a = _step_inputs(2, 16, 16, torch.bfloat16, seed=4)
    y0, h_new = ops.ssd_step(*a)
    h0 = a[-1]
    ptr = h0.data_ptr()
    y1, h1 = ops.ssd_step(*a[:-1], h0, out=h0)
    assert h1.data_ptr() == ptr and torch.equal(h1, h_new)
    assert torch.equal(y0, y1)
    y2, _ = ops.ssd_step(*(t.contiguous() for t in a[:-1]), h_new.clone())
    assert torch.equal(y2, mamba_step_plain(*a[:-1], h_new)[0])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_step(B, hd, ns, dtype=torch.bfloat16, nh=NH):
    """A whole step's inputs on ``meta``, the rows views of a conv output
    and of a projection as ``apply_mamba`` hands them over."""
    d_in = nh * hd
    conv = _meta(B, d_in + 2 * ns, dtype=dtype)
    proj = _meta(B, 2 * d_in + 2 * ns + nh, dtype=dtype)
    return (conv[:, :d_in], conv[:, d_in:d_in + ns], conv[:, d_in + ns:],
            proj[:, d_in + 2 * ns:2 * d_in + 2 * ns], proj[:, -nh:],
            _meta(nh), _meta(nh), _meta(nh), _meta(B, nh, hd, ns))


@pytest.fixture
def fake_m1(monkeypatch):
    """A fake library that records each launch; the plain version fails
    the test if called off the CPU; the current stream is 7."""
    calls = []

    class Lib:
        def ssd_step_launch(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(mk, "_lib", lambda: Lib())
    monkeypatch.setattr(mk, "mamba_step_plain", lambda *a: pytest.fail(
        "plain version off the CPU"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    return calls


def test_off_the_cpu_launches_m1_or_raises(fake_m1):
    """A ``meta`` tensor goes to the kernel, never to the plain version: a
    fake library sees the launch (pointers, B, nh, hd, ns, the rows'
    strides as they lie, the dtype's code, the stream) and the count
    rises; a shape without an instance, an f16 input and mismatched shapes
    raise before any launch."""
    B, hd, ns = 3, 64, 64
    a = _meta_step(B, hd, ns)
    before = mk.ssd_step.launches
    y, h = mk.ssd_step(*a, out=a[-1])
    d_in, w = NH * hd, 2 * NH * hd + 2 * ns + NH
    assert h is a[-1] and tuple(y.shape) == (B, d_in)
    assert y.dtype == torch.bfloat16
    assert len(fake_m1) == 1 and fake_m1[0][11:] == (
        B, NH, hd, ns, d_in + 2 * ns, d_in + 2 * ns, d_in + 2 * ns, w, w, 1,
        7)
    assert fake_m1[0][8] == fake_m1[0][10] == a[-1].data_ptr()
    assert mk.ssd_step.launches == before + 1
    with pytest.raises(ValueError, match="the kernel takes"):
        mk.ssd_step(*_meta_step(B, 32, 32))
    with pytest.raises(TypeError, match="float32 / bfloat16"):
        mk.ssd_step(*_meta_step(B, hd, ns, dtype=torch.float16))
    with pytest.raises(ValueError, match="shapes"):
        mk.ssd_step(*a[:4], _meta(B, NH + 1, dtype=torch.bfloat16), *a[5:])
    assert len(fake_m1) == 1


def _refusals():
    """(name, the step's arguments, error, message) of every input the
    kernel refuses."""
    B, hd, ns = 2, 64, 64
    a = list(_meta_step(B, hd, ns))
    bad = {}
    bad["rows of mixed dtypes"] = (a[:3] + [a[3].float()] + a[4:],
                                   TypeError, "float32 / bfloat16")
    bad["a bf16 state"] = (a[:8] + [a[8].bfloat16()], TypeError,
                           "float32 / bfloat16")
    bad["a bf16 d_skip"] = (a[:7] + [a[7].bfloat16()] + a[8:], TypeError,
                            "float32 / bfloat16")
    bad["a strided row"] = ([_meta(B, 2 * NH * hd, dtype=torch.bfloat16)[
        :, ::2]] + a[1:], ValueError, "contiguous")
    bad["a strided layer vector"] = (a[:5] + [_meta(2 * NH)[::2]] + a[6:],
                                     ValueError, "contiguous")
    bad["a misaligned state"] = (a[:8] + [_meta(B * NH * hd * ns + 1)[1:]
                                          .view(B, NH, hd, ns)],
                                 ValueError, "16 bytes")
    bad["(64, 16)"] = (list(_meta_step(B, 64, 16)), ValueError,
                       "the kernel takes")
    return bad


@pytest.mark.parametrize("name", list(_refusals()))
def test_off_the_cpu_refuses(fake_m1, name):
    """Off the CPU every input the kernel does not take raises before any
    launch: a wrong dtype, a strided row or vector, a state off 16 bytes,
    a shape without an instance."""
    args, err, msg = _refusals()[name]
    with pytest.raises(err, match=re.escape(msg)):
        mk.ssd_step(*args)
    assert fake_m1 == []


def test_apply_mamba_decode_calls_the_step_once_on_views(monkeypatch):
    """``apply_mamba``'s decode hands the step the conv output's and the
    projection's rows as they lie (views, no copy), the layer's vectors and
    the cache's state as ``out`` (the step in place), once a call, and
    feeds its output to the gated norm; the prefill never calls it."""
    cfg = configs.get_smoke("zamba2-1.2b")
    params = M.init_params(cfg, seed=0, device="cpu")
    p = M._take(params["blocks"][0]["mixer"], 0)
    d_in = cfg.ssm_expand * cfg.d_model
    ns = cfg.ssm_state
    seen = []
    entry = ops.ssd_step

    def spy(*a, **kw):
        seen.append((a, kw))
        return entry(*a, **kw)

    monkeypatch.setattr(ops, "ssd_step", spy)
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3)).to(torch.bfloat16)
    _, cache = mamba2.apply_mamba(p, x[:, :5], cfg, collect=True)
    assert seen == []
    cache["ssm"] = cache["ssm"].float()
    ptr = cache["ssm"].data_ptr()
    out, c2 = mamba2.apply_mamba(p, x[:, 5:], cfg, cache=cache)
    assert len(seen) == 1 and c2 is cache
    (xs, b, c, z, dt, a_log, dt_bias, d_skip, h0), kw = seen[0]
    assert kw["out"] is cache["ssm"] and h0 is cache["ssm"]
    assert cache["ssm"].data_ptr() == ptr
    assert xs.stride(0) == b.stride(0) == c.stride(0) == d_in + 2 * ns
    assert z.stride(0) == dt.stride(0) == p["w_in"].shape[-1]
    assert a_log is p["a_log"] and dt_bias is p["dt_bias"]
    assert d_skip is p["d_skip"]
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def _code() -> str:
    return re.sub(r"//[^\n]*", "", open(SRC).read())


def test_source_keeps_the_emulated_order():
    """No FMA; dt' torch's softplus (threshold 20, ``log1pf(expf(v))``) and
    the decay ``expf(-expf(a_log) dt')``; the state
    ``__fadd_rn(__fmul_rn(h, e), __fmul_rn(x dt', B))``; y a ``__fadd_rn``
    of ``__fmul_rn`` products from +0 over s in order, then the skip, the
    gate ``z / (1 + expf(-z))`` rounded by ``__fdiv_rn`` and each narrowing
    to nearest even; the tile's loads issued before the prologue, 16-byte
    pieces on consecutive lanes, a padded shared copy; the instances are
    the wrapper's; the source is a build target with a launch count."""
    code = _code()
    assert re.search(r"fma", code, re.IGNORECASE) is None
    for line in (
            "hv[j] = __ldcs(src + t + NT * j);",
            "const float v = __fadd_rn(widen(dt[row * sdt + head]), "
            "dt_bias[head]);",
            "const float dtp = v > 20.f ? v : log1pf(expf(v));",
            "const float e = expf(__fmul_rn(-expf(a_log[head]), dtp));",
            "const float xd = __fmul_rn(widen(xrow[d]), dtp);",
            "n.x = __fadd_rn(__fmul_rn(hv[j].x, e), __fmul_rn(xd, b0));",
            "n.w = __fadd_rn(__fmul_rn(hv[j].w, e), __fmul_rn(xd, b3));",
            "__stcs(dst + k, n);",
            "__shared__ float sh[HD * (NS + 1)];",
            "float acc = 0.f;",
            "acc = __fadd_rn(acc, __fmul_rn(sc_s[s], hrow[s]));",
            "__fadd_rn(acc, __fmul_rn(d_skip[head], widen(xrow[t]))));",
            "round_to<T>(__fdiv_rn(zd, __fadd_rn(1.f, expf(-zd))));",
            "narrow<T>(__fmul_rn(y, gate));",
            "return __float2bfloat16_rn(v);"):
        assert line in code, line
    assert code.index("__ldcs(src") < code.index("log1pf")
    assert code.count("for (int s = 0; s < NS; ++s)") == 1
    inst = re.findall(r"if \(hd == (\d+) && ns == (\d+)\)", code)
    assert tuple((int(a), int(b)) for a, b in inst) == mk.INSTANCES
    assert build.SOURCES["ssd_step"] == pathlib.Path(SRC)
    assert not any("fast" in f or "fmad" in f for f in build.NVCC_FLAGS)
    assert "ssd_step" in __import__("repro_torch.kernels",
                                    fromlist=["x"]).launch_counters()


def test_binding_matches_the_launcher(monkeypatch):
    """The wrapper's argument types are the launcher's: eleven pointers
    (xs, b, c, z, dt, a_log, dt_bias, d_skip, h0, out, h1), four ints (B,
    nh, hd, ns), five 64-bit row strides, the dtype's code, the stream; the
    codes are the launcher's."""
    sig = re.search(r"int ssd_step_launch\(([^)]*)\)", _code()).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "xs", "b", "c", "z", "dt", "a_log", "dt_bias", "d_skip", "h0", "out",
        "h1", "B", "nh", "hd", "ns", "sxs", "sb", "sc", "sz", "sdt", "dtype",
        "stream"]
    kind = {"*": mk._P, "long long": mk._L, "int": mk._I}
    want = [next(v for k, v in kind.items() if k in p) for p in params]
    fake = types.SimpleNamespace(ssd_step_launch=types.SimpleNamespace())
    monkeypatch.setattr(build, "load", lambda name: fake)
    assert mk._lib.__wrapped__() is fake
    assert fake.ssd_step_launch.argtypes == want
    codes = re.findall(r"if \(dtype == (\d)\)\s*return dispatch<(\w+)>",
                       _code())
    assert {int(c): t for c, t in codes} == {
        mk.DTYPES[torch.float32]: "float",
        mk.DTYPES[torch.bfloat16]: "__nv_bfloat16"}
    assert inspect.getsource(mk._lib).count("[_P] * 11") == 1
