"""M1, the one-token Mamba-2 SSD step (``kernels/ssd/csrc/ssd_step.cu``),
on the CPU.

The kernel runs only on the card; here its two plain forms are held:

* ``ref.ssd_step_plain`` (the CPU path of ``kernel.ssd_step``) against the
  reference's decode branch (``src/repro/models/mamba2.py:144-147``, its
  einsums in jax), within 1e-6 of the largest |value|;
* ``ref.ssd_step_ordered`` (M1's order: the state as plain, y summed over
  s = 0, 1, ... from +0): its state ``torch.equal`` to plain, y within
  1e-6 of plain and equal to a sequential sum written out scalar by scalar,
  rows at B 1-16 ``torch.equal`` to the row alone;
* the wrapper: the step in place (``out=`` the state), the refusal of a
  shape without an instance and of a dtype on a tensor off the CPU, the
  kernel reached (a fake library) and never the plain version off the
  CPU, and its count; the source's order and its binding.
"""
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd import kernel as mk
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_step_ordered, ssd_step_plain

SRC = str(pathlib.Path(mk.__file__).parent / "csrc" / "ssd_step.cu")
SHAPES = [(64, 64), (16, 16)]       # (hd, ns): zamba2-1.2b CONFIG, SMOKE
NH = 4
REL = 1e-6


def _inputs(B, hd, ns, seed=0, nh=NH):
    """x, e, b, c, h0 (f32) of a step: e in (0, 1], the decay a state sees
    at the small config's dt."""
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    e = torch.from_numpy(rng.uniform(0.05, 1.0, (B, nh)).astype(np.float32))
    return t(B, nh, hd), e, t(B, ns), t(B, ns), t(B, nh, hd, ns)


def _close(got, want, what):
    big = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= REL * big, f"{what}: {err} > {REL} x {big}"


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


def test_step_in_place_is_the_fresh_step():
    """``out=`` the state: the same y and the same state bits as a step
    into a fresh tensor, written into h0's own storage."""
    x, e, b, c, h0 = _inputs(2, 16, 16, seed=4)
    y0, h_new = ops.ssd_step(x, e, b, c, h0)
    ptr = h0.data_ptr()
    y1, h1 = ops.ssd_step(x, e, b, c, h0, out=h0)
    assert h1.data_ptr() == ptr and torch.equal(h1, h_new)
    assert torch.equal(y0, y1)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_off_the_cpu_launches_m1_or_raises(monkeypatch):
    """A ``meta`` tensor goes to the kernel, never to the plain version: a
    fake library sees the launch (pointers, B, nh, hd, ns, the stream) and
    the count rises; a shape without an instance, a bf16 input and
    mismatched shapes raise before any launch."""
    calls = []

    class Lib:
        def ssd_step_launch(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(mk, "_lib", lambda: Lib())
    monkeypatch.setattr(mk, "ssd_step_plain", lambda *a: pytest.fail(
        "plain version off the CPU"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    B, hd, ns = 3, 64, 64
    args = (_meta(B, NH, hd), _meta(B, NH), _meta(B, ns), _meta(B, ns),
            _meta(B, NH, hd, ns))
    before = mk.ssd_step.launches
    y, h = mk.ssd_step(*args, out=args[4])
    assert h is args[4] and tuple(y.shape) == (B, NH, hd)
    assert len(calls) == 1 and calls[0][7:] == (B, NH, hd, ns, 7)
    assert mk.ssd_step.launches == before + 1
    with pytest.raises(ValueError, match="the kernel takes"):
        mk.ssd_step(_meta(B, NH, 32), args[1], _meta(B, 32), _meta(B, 32),
                    _meta(B, NH, 32, 32))
    with pytest.raises(TypeError, match="float32"):
        mk.ssd_step(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="shapes"):
        mk.ssd_step(args[0], _meta(B, NH + 1), *args[2:])
    assert len(calls) == 1


def _code() -> str:
    return re.sub(r"//[^\n]*", "", open(SRC).read())


def test_source_keeps_the_emulated_order():
    """No FMA; the state is ``__fadd_rn(__fmul_rn(h, e), __fmul_rn(x,
    B))``; y a ``__fadd_rn`` of ``__fmul_rn`` products from +0 over s in
    order; the instances are the wrapper's; the source is a build target
    with a launch count."""
    code = _code()
    assert re.search(r"fma", code, re.IGNORECASE) is None
    assert "float acc = 0.f;" in code
    assert ("hv[s] = __fadd_rn(__fmul_rn(hv[s], ed), __fmul_rn(xd, sb[s]));"
            in code)
    assert "acc = __fadd_rn(acc, __fmul_rn(sc[s], hv[s]));" in code
    assert code.count("for (int s = 0; s < NS; ++s)") == 1
    inst = re.findall(r"if \(hd == (\d+) && ns == (\d+)\)", code)
    assert tuple((int(a), int(b)) for a, b in inst) == mk.INSTANCES
    assert build.SOURCES["ssd_step"] == pathlib.Path(SRC)
    assert not any("fast" in f or "fmad" in f for f in build.NVCC_FLAGS)
    assert "ssd_step" in __import__("repro_torch.kernels",
                                    fromlist=["x"]).launch_counters()


def test_binding_matches_the_launcher():
    """The wrapper's argument types are the launcher's: seven pointers
    (x, e, b, c, h0, y, h1), four ints (B, nh, hd, ns), the stream."""
    sig = re.search(r"int ssd_step_launch\(([^)]*)\)", _code()).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert [p.split()[-1].lstrip("*") for p in params] == [
        "x", "e", "b", "c", "h0", "y", "h1", "B", "nh", "hd", "ns", "stream"]
    assert inspect.getsource(mk._lib).count("[_P] * 7 + [_I] * 4 + [_P]") == 1
