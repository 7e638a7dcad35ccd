"""Port vs reference: MoE routing, the routed dispatch stream, two-phase
route/execute, and the bcsr == gather law inside the port.

TINY is the serving test config of the reference (``tests/test_serve_loop.py``:
capacity_factor 1.0, so tokens really drop), in f32.  Routing integers and
the routed stream must match exactly; the gate within 1e-6; layer outputs
within atol 1e-5 (summation order differs between the frameworks).  Inside
the port the two dispatch backends must be bit-identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as rmoe
from repro.models.config import ArchConfig as RArchConfig

from repro_torch.interop import params_from_jax
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)

TINY_KW = dict(
    name="tiny-serve", family="moe", d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"), n_repeats=2,
    head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
RTINY, TINY = RArchConfig(**TINY_KW), ArchConfig(**TINY_KW)


@pytest.fixture(scope="module")
def layer():
    rp = rmoe.init_moe(jax.random.PRNGKey(0), RTINY)
    p = params_from_jax(jax.device_get(rp), TINY, device="cpu")
    # B = 4: the reference bcsr layer needs a batch that is a multiple of the
    # 4 virtual CPU devices (smaller batches raise ShardingTypeError there)
    x = np.random.default_rng(1).standard_normal((4, 12, 32)).astype(np.float32)
    return rp, p, x


def test_route_tokens_matches_reference(layer):
    rp, p, x = layer
    want = rmoe.route_tokens(rp["router"], jnp.asarray(x), RTINY)
    got = moe.route_tokens(p["router"], torch.from_numpy(x), TINY)
    assert int((~got.keep).sum()) > 0, "config must actually drop tokens"
    for f in ("expert_id", "slot", "within", "keep", "new_counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.gate.numpy(), np.asarray(want.gate),
                               atol=1e-6, rtol=0)
    # a decode-shaped call with carried occupancy at a later position
    counts = np.array(want.new_counts)
    w1 = rmoe.route_tokens(rp["router"], jnp.asarray(x[:, :1]), RTINY,
                           counts=jnp.asarray(counts), pos0=12)
    g1 = moe.route_tokens(p["router"], torch.from_numpy(x[:, :1]), TINY,
                          counts=torch.from_numpy(counts), pos0=12)
    for f in ("slot", "keep", "new_counts"):
        np.testing.assert_array_equal(getattr(g1, f).numpy(),
                                      np.asarray(getattr(w1, f)), err_msg=f)
    for t in (0, 9, 12, 100):
        assert int(moe.prefix_capacity(torch.tensor(t), 4, 1.25)) == \
            int(rmoe.prefix_capacity(t, 4, 1.25))
        assert moe.dispatch_capacity(t + 1, TINY, pos0=t) == \
            rmoe.dispatch_capacity(t + 1, RTINY, pos0=t)


@pytest.mark.parametrize("min_bucket", [None, 8, 32])
def test_routed_stream_matches_reference(min_bucket):
    rng = np.random.default_rng(3)
    B, S, E, C = 3, 20, 4, 6
    M = E * C
    fs = rng.integers(0, M + 1, (B, S)).astype(np.int32)   # M = dropped
    want = rmoe._build_routed_stream(fs, S, E, C, 8, 8, jnp.float32,
                                     min_bucket=min_bucket)
    got = moe._build_routed_stream(fs, S, E, C, 8, 8, torch.float32, "cpu",
                                   min_bucket=min_bucket)
    assert got[1:] == want[1:]          # nnzb_routed, nnzb_covered
    for f in ("indptr", "block_rows", "block_cols", "blocks"):
        np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                      np.asarray(getattr(want[0], f)))
    assert got[0].shape == want[0].shape
    with pytest.raises(ValueError):
        moe._build_routed_stream(fs - 1, S, E, C, 8, 8, torch.float32, "cpu")


@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
def test_apply_moe_matches_reference(layer, dispatch):
    rp, p, x = layer
    want, wc = rmoe.apply_moe(rp, jnp.asarray(x), RTINY, dispatch=dispatch)
    got, gc = moe.apply_moe(p, torch.from_numpy(x), TINY, dispatch=dispatch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_two_phase_bcsr_matches_reference_and_gather(layer):
    """route_moe + execute_moe (bcsr) vs the reference bcsr layer, and the
    port's bcsr == gather law (dispatch buffers and outputs equal)."""
    rp, p, x = layer
    want, _ = rmoe.apply_moe(rp, jnp.asarray(x), RTINY, dispatch="bcsr")
    xt = torch.from_numpy(x)
    plan, info = moe.route_moe(p, xt, TINY, dispatch="bcsr")
    assert info["nnzb_stream"] == info["bucket"] >= info["nnzb_covered"]
    assert info["grid_nnzb"] == np.prod(plan.stream.grid_shape)
    got, counts = moe.execute_moe(p, xt, plan, TINY)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    gplan, ginfo = moe.route_moe(p, xt, TINY, dispatch="gather")
    assert gplan.stream is None and "nnzb_stream" not in ginfo
    ggot, gcounts = moe.execute_moe(p, xt, gplan, TINY)
    assert torch.equal(got, ggot) and torch.equal(counts, gcounts)
    C, E = plan.capacity, TINY.n_experts
    assert torch.equal(moe._dispatch_stream(xt, plan.stream, E, C),
                       moe._dispatch_gather(xt, plan.flat_slot, E, C))


def test_two_phase_stepwise_decode_matches_reference(layer):
    """Token-by-token route/execute with carried occupancy reproduces the
    reference's stepwise bcsr layer."""
    rp, p, x = layer
    rcounts, counts = None, None
    for t in range(x.shape[1]):
        want, rcounts = rmoe.apply_moe(rp, jnp.asarray(x[:, t:t + 1]), RTINY,
                                       counts=rcounts, pos=t, dispatch="bcsr")
        plan, _ = moe.route_moe(p, torch.from_numpy(x[:, t:t + 1]), TINY,
                                counts=counts, pos=t, dispatch="bcsr")
        got, counts = moe.execute_moe(p, torch.from_numpy(x[:, t:t + 1]),
                                      plan, TINY)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))


def test_plan_from_phase1_defaults_to_the_phase1_device(layer):
    """Without ``device``, the routed stream lands where the phase-1
    tensors are (here the CPU) and equals the stream of an explicit
    ``device="cpu"``."""
    _, p, x = layer
    xt = torch.from_numpy(x)
    plan, _ = moe.route_moe(p, xt, TINY, dispatch="bcsr")
    phase1 = moe.Phase1(plan.gate, plan.keep, plan.new_counts,
                        plan.flat_slot, plan.capacity)
    got, _ = moe.plan_from_phase1(phase1, TINY, dispatch="bcsr")
    want, _ = moe.plan_from_phase1(phase1, TINY, dispatch="bcsr",
                                   device="cpu")
    assert got.stream.blocks.device.type == "cpu"
    for f in ("indptr", "block_rows", "block_cols", "blocks"):
        assert torch.equal(getattr(got.stream, f), getattr(want.stream, f))
