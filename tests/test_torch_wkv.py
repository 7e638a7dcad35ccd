"""Port vs reference: the WKV recurrence (K7) on the CPU.

The port's plain chunked WKV (``kernels/wkv/ref.wkv_chunked_plain``, what
the K7 wrapper runs for CPU tensors) is held against the reference's Pallas
kernel in interpret mode (``ops.wkv(..., interpret=True)``) and against the
model's pure-JAX ``wkv_chunked``, ``y`` and the final state, over the
reference's own sweep (tests/test_kernels_wkv.py): (T, chunk) in {(64, 16),
(100, 32), (256, 128)} x decay magnitude {0.05, 1.0}, B 2, 3 heads of 16,
inputs drawn with numpy.

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
    # the chunk is the largest multiple of the kernel's 16-row interleave
    # whose shared memory fits one block
    assert tuning.wkv_smem_bytes(tuning.WKV_CHUNK) <= tuning.SMEM_BUDGET
    assert tuning.wkv_smem_bytes(tuning.WKV_CHUNK + 16) > tuning.SMEM_BUDGET
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
