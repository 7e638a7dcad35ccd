"""Port vs reference: the WKV recurrence (K7) on the CPU.

The port's plain chunked WKV (``kernels/wkv/ref.wkv_chunked_plain``, what
the K7 wrapper runs for CPU tensors) is held against the reference's Pallas
kernel in interpret mode (``ops.wkv(..., interpret=True)``) and against the
model's pure-JAX ``wkv_chunked``, ``y`` and the final state, over the
reference's own sweep (tests/test_kernels_wkv.py): (T, chunk) in {(64, 16),
(100, 32), (256, 128)} x decay magnitude {0.05, 1.0}, B 2, 3 heads of 16,
inputs drawn with numpy.

The CUDA kernel runs its dots on the tensor cores as 3xTF32 (hi and lo
TF32 halves of each f32 operand, three products); a plain-torch emulation
of its arithmetic (``_emulate_k7``) is held against the same references
here, and a single TF32 pass is shown to miss the tolerance.

Tolerance: within 2e-5 of the largest |value|.  The sides sum in other
orders, and with the mid-chunk rescale an exponent reaches about half a
chunk of decay (64 at the clamp), where one f32 ulp of the argument is
~4e-6 of the exponential: the reference's own chunked form sits 2.5e-6 of
the largest value from its sequential oracle at (256, 128), wmag 1.0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tuning as rtuning
from repro.kernels.wkv import ops as rops
from repro.models.rwkv6 import rwkv_scan_ref, wkv_chunked

from repro_torch.kernels import tuning
from repro_torch.kernels.wkv import kernel as wk
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv.ref import wkv_chunked_plain, wkv_scan

RTOL_MAX = 2e-5


def _inputs(seed, B, T, nh, hd, wmag):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, nh, hd)).astype(np.float32)
               for _ in range(3))
    w = np.maximum(-np.abs(rng.standard_normal((B, T, nh, hd))
                           .astype(np.float32)) * np.float32(wmag),
                   np.float32(-1.0))
    u = rng.standard_normal((nh, hd)).astype(np.float32) * np.float32(0.1)
    return r, k, v, w, u


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    big = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= RTOL_MAX * big, f"{what}: {err} > {RTOL_MAX} x {big}"


@pytest.mark.parametrize("T,chunk", [(64, 16), (100, 32), (256, 128)])
@pytest.mark.parametrize("wmag", [0.05, 1.0])  # incl. clamp-saturating decay
def test_plain_matches_reference_kernel_and_chunked(T, chunk, wmag):
    a = _inputs(T + int(100 * wmag), 2, T, 3, 16, wmag)
    y, s = wkv_chunked_plain(*map(torch.from_numpy, a), chunk)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (2, T, 3, 16) and tuple(s.shape) == (2, 3, 16, 16)
    ja = [jnp.asarray(x) for x in a]
    _close(y, rops.wkv(*ja, chunk=chunk, interpret=True), "y vs wkv_pallas")
    cy, cs = wkv_chunked(*ja, chunk=chunk)
    _close(y, cy, "y vs wkv_chunked")
    _close(s, cs, "s_last vs wkv_chunked")
    # the public entries on CPU tensors take the plain version as it is
    t = list(map(torch.from_numpy, a))
    assert torch.equal(ops.wkv(*t, chunk=chunk), y)
    sy, ss = ops.wkv_state(*t, chunk=chunk)
    assert torch.equal(sy, y) and torch.equal(ss, s)


def test_plain_bf16_inputs_match_reference_kernel():
    r, k, v, w, u = _inputs(7, 1, 64, 2, 16, 0.1)
    rb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (r, k, v))
    got = ops.wkv(rb, kb, vb, torch.from_numpy(w), torch.from_numpy(u),
                  chunk=32)
    want = rops.wkv(*(jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)),
                    jnp.asarray(w), jnp.asarray(u), chunk=32, interpret=True)
    assert got.dtype == torch.float32
    _close(got, want, "bf16 inputs")


def test_scan_matches_reference_oracle():
    a = _inputs(11, 2, 40, 3, 16, 1.0)
    y, s = wkv_scan(*map(torch.from_numpy, a))
    ry, rs = rwkv_scan_ref(*map(jnp.asarray, a))
    _close(y, ry, "wkv_scan y")
    _close(s, rs, "wkv_scan state")
    # and the chunked plain version agrees with the oracle in f64
    y64, s64 = wkv_scan(*(torch.from_numpy(x).double() for x in a))
    yc, sc = wkv_chunked_plain(*map(torch.from_numpy, a), 16)
    _close(yc, y64, "chunked vs f64 scan")
    _close(sc, s64, "chunked state vs f64 scan")


def test_chunk_clamp_and_flops_match_reference():
    for t in (1, 5, 8, 33, 100, 128, 129, 1000, 4096):
        for rdt, dt in ((jnp.float32, torch.float32),
                        (jnp.bfloat16, torch.bfloat16)):
            assert tuning.wkv_chunk(t, dt, "cpu") == rtuning.wkv_chunk(t, rdt)
            # the card pads T to the kernel's one chunk and never clamps
            assert tuning.wkv_chunk(t, dt, "cuda") == tuning.WKV_CHUNK
    # the kernel's layout: six (chunk, hd) f32 tiles and no (chunk, chunk)
    # one (the scores stay in registers), 215,040 bytes at the kernel's
    # chunk; one block fits an SM and two do not, so the next chunk's loads
    # are hidden by fetching it behind this one's products
    grow = tuning.wkv_smem_bytes(2 * tuning.WKV_CHUNK) \
        - tuning.wkv_smem_bytes(tuning.WKV_CHUNK)
    assert grow == 6 * tuning.WKV_CHUNK * 64 * 4
    assert tuning.wkv_smem_bytes(tuning.WKV_CHUNK) == 215_040
    assert tuning.wkv_smem_bytes(tuning.WKV_CHUNK) <= tuning.SMEM_BUDGET
    assert 2 * tuning.wkv_smem_bytes(tuning.WKV_CHUNK) > tuning.SMEM_BUDGET
    for args in ((2, 256, 4, 64, 128), (4, 2048, 64, 64, 128),
                 (1, 100, 3, 16, 32)):
        assert ops.flops(*args) == rops.flops(*args)
    assert ops.flops(4, 2048, 64, 64, 128) == 25_769_803_776


def test_card_request_raises_and_never_runs_plain(monkeypatch):
    """Numpy input defaults to the card; without one that raises.  A tensor
    on any device but the CPU goes to the kernel or raises: the plain
    version is never its fallback."""
    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for a non-CPU request")

    monkeypatch.setattr(wk, "wkv_chunked_plain", no_plain)
    a = _inputs(3, 1, 32, 1, 64, 0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.wkv(*a)
    meta = [torch.empty(x.shape, device="meta") for x in a]
    with pytest.raises(ValueError, match="CUDA device"):
        wk.wkv_kernel(*meta, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wk.wkv_kernel(*map(torch.from_numpy, a), chunk=48)


# -- the CUDA kernel's arithmetic, emulated -------------------------------

LOG2E = 1.4426950408889634


def _tf32_rna(x):
    """f32 -> the nearest TF32 (10 mantissa bits), ties away from zero:
    cvt.rna.tf32.f32, which the kernel does as an add and a mask."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor cores read of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _dot(a, b, split=True):
    """a @ b as the kernel's mma.sync tf32 computes it: with ``split``, the
    3xTF32 sum lo hi + hi lo + hi hi (hi = rna(x), lo = x - hi read as
    TF32), accumulated in f32; without, one TF32 pass."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if not split:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulate_k7(r, k, v, w, u, chunk, split=True, forms=None):
    """The K7 kernel's chunk recurrence in plain torch, f32: the cumsum of
    w log2(e) (every exponential a power of 2), ri_s = r 2^(excl - mid),
    kj_s = k 2^(mid - cum), the strictly lower att = ri_s kj_s^T, y = att v
    + ri_s Sm + ((r u) . k) v with Sm = diag(2^mid) S, and the state
    carried as S' = diag(2^(last - mid)) (Sm + kj_s^T v).  ``forms``, a
    list, collects each chunk's ri_s 2^mid and kj_s 2^(last - mid) (the
    reference's r exp(excl) and k exp(last - cum), which the kernel never
    forms).  Returns (y (B, T, nh, hd), final state (B, nh, hd, hd))."""
    r, k, v, w, u = (x.float() for x in (r, k, v, w, u))
    B, T, nh, hd = r.shape
    pad = (-T) % chunk
    if pad:
        r, k, v, w = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                      for x in (r, k, v, w))
    nc = (T + pad) // chunk

    def chunks(x):  # (nc, B, nh, Q, hd)
        return x.reshape(B, nc, chunk, nh, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(chunks, (r, k, v, w))
    lower = torch.ones(chunk, chunk, dtype=torch.bool).tril(-1)
    S = torch.zeros(B, nh, hd, hd)
    ys = []
    for c in range(nc):
        cum = torch.cumsum(wc[c] * torch.tensor(LOG2E, dtype=torch.float32),
                           dim=2)
        excl = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]],
                         dim=2)
        mid = cum[:, :, chunk // 2:chunk // 2 + 1]
        last = cum[:, :, -1:]
        ri_s = rc[c] * torch.exp2(excl - mid)
        kj_s = kc[c] * torch.exp2(mid - cum)
        if forms is not None:
            forms += [ri_s * torch.exp2(mid), kj_s * torch.exp2(last - mid)]
        Sm = S * torch.exp2(mid).transpose(-1, -2)
        att = torch.where(lower, _dot(ri_s, kj_s.transpose(-1, -2), split),
                          torch.zeros(()))
        bonus = ((rc[c] * u[None, :, None, :]) * kc[c]).sum(-1, keepdim=True)
        ys.append(_dot(att, vc[c], split) + _dot(ri_s, Sm, split)
                  + bonus * vc[c])
        S = torch.exp2(last - mid).transpose(-1, -2) * (
            Sm + _dot(kj_s.transpose(-1, -2), vc[c], split))
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, nc * chunk, nh, hd)
    return y[:, :T], S


@pytest.mark.parametrize("T,chunk", [(64, 16), (100, 32), (256, 128)])
@pytest.mark.parametrize("wmag", [0.05, 1.0])
def test_emulated_kernel_arithmetic_matches_reference(T, chunk, wmag):
    """The 3xTF32 emulation of K7 against the f64 sequential scan (y and the
    state) and the reference's Pallas kernel in interpret mode (y), over
    the reference's sweep."""
    a = _inputs(T + int(100 * wmag), 2, T, 3, 16, wmag)
    y, s = _emulate_k7(*map(torch.from_numpy, a), chunk)
    exact_y, exact_s = wkv_scan(*(torch.from_numpy(x).double() for x in a))
    _close(y, exact_y, "3xTF32 emulation y vs f64 scan")
    _close(s, exact_s, "3xTF32 emulation state vs f64 scan")
    _close(y, rops.wkv(*map(jnp.asarray, a), chunk=chunk, interpret=True),
           "3xTF32 emulation y vs wkv_pallas")


def test_single_tf32_pass_misses_tolerance_where_split_does_not():
    """Why the kernel splits: at its own shape (hd 64, chunk 128), one TF32
    pass per product lands ~20x outside the tolerance, 3xTF32 inside."""
    a = _inputs(21, 1, 256, 2, 64, 1.0)
    t = list(map(torch.from_numpy, a))
    exact_y, _ = wkv_scan(*(x.double() for x in t))
    big = exact_y.abs().max().item()
    errs = {split: (_emulate_k7(*t, 128, split=split)[0].double()
                    - exact_y).abs().max().item() / big
            for split in (True, False)}
    assert errs[True] <= RTOL_MAX, errs
    assert errs[False] > 5 * RTOL_MAX, errs


def test_emulated_state_factors_finite_at_the_clamp():
    """w = -1 at every position (the decay clamp): the factors the kernel
    moves onto the state, 2^mid and 2^(last - mid), and the products they
    stand for stay finite, and the result holds the tolerance."""
    r, k, v, _, u = _inputs(5, 1, 256, 2, 64, 1.0)
    w = np.full_like(r, -1.0)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    forms = []
    y, s = _emulate_k7(*t, 128, forms=forms)
    assert len(forms) == 4
    assert all(bool(torch.isfinite(f).all()) for f in forms)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    exact_y, exact_s = wkv_scan(*(x.double() for x in t))
    _close(y, exact_y, "clamp y vs f64 scan")
    _close(s, exact_s, "clamp state vs f64 scan")
