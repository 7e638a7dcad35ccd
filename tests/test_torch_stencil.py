"""Port vs reference: the stencil ops (K6a ``stencil_2d``, K6b
``stencil_3d``) on the reference test's shapes (``test_kernels_stencil.py``),
ragged ones included, f32 and bf16.

The reference runs its Pallas kernels in interpret mode; the port's CPU path
is the plain version of its CUDA kernel.  The Pallas body may fuse ``acc +
c * tap`` into one FMA on the CPU, the port rounds the product first (as
the reference's own oracle does), so f32 compares within atol = rtol =
1e-5, and a bf16 result within one bf16 ulp (rtol 2**-7) of the value plus
1e-5.  Against the reference's oracle ``stencil_ref`` the port is equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.stencils import STENCILS as R_STENCILS
from repro.kernels.stencil import ops as r_ops
from repro.kernels import tuning as r_tuning
from repro.kernels.stencil.ref import stencil_ref as r_stencil_ref

from repro_torch.core.stencils import STENCILS
from repro_torch.interop import to_tensor
from repro_torch.kernels import tuning
from repro_torch.kernels.stencil import kernel, ops

torch.set_num_threads(2)
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=1e-5, rtol=2.0 ** -7)}


def _grid(seed, shape, r, dtype):
    g = np.random.default_rng(seed).standard_normal(
        tuple(s + 2 * r for s in shape))
    return jnp.asarray(g, getattr(jnp, dtype))


def _check(name, shape, dtype, tile):
    rspec = R_STENCILS[name]
    grid = _grid(42, shape, rspec.radius, dtype)
    want = r_ops.apply(grid, rspec, tile=tile, interpret=True)
    pgrid = to_tensor(np.asarray(grid))
    got = ops.apply(pgrid, STENCILS[name], tile=tile)
    assert got.dtype == pgrid.dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(r_stencil_ref(grid, rspec), np.float32))


@pytest.mark.parametrize("name", ["j2d5pt", "j2d9pt", "j2d9pt-gol"])
@pytest.mark.parametrize("shape", [(16, 128), (24, 136), (64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_2d_matches_reference(name, shape, dtype):
    _check(name, shape, dtype, (8, 128))


@pytest.mark.parametrize("name", ["j3d7pt", "j3d27pt"])
@pytest.mark.parametrize("shape", [(8, 8, 128), (10, 20, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stencil_3d_matches_reference(name, shape, dtype):
    _check(name, shape, dtype, (4, 8, 128))


def test_stencil_flops_and_plain_path():
    """``flops`` equals the reference's; a CPU grid takes the plain version
    (no launch) and gives the same result for any tile; numpy input goes to
    the device that is asked for."""
    for name, spec in STENCILS.items():
        interior = (10, 10, 10)[:spec.ndim]
        assert ops.flops(spec, interior) == r_ops.flops(R_STENCILS[name],
                                                        interior)
    spec = STENCILS["j2d9pt-gol"]
    g = np.random.default_rng(1).standard_normal((20, 37)).astype(np.float32)
    before = kernel.stencil_2d.launches
    a = ops.apply(torch.from_numpy(g), spec)
    b = ops.apply(g, spec, tile=(3, 5), device="cpu")
    assert torch.equal(a, b) and kernel.stencil_2d.launches == before
    with pytest.raises(ValueError):
        ops.apply(torch.from_numpy(g), STENCILS["j3d7pt"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tuning_rows(dtype):
    """CPU tiles equal the reference's CPU tiles (its sublane / lane
    clamp); the card's tiles are no larger than the interior."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for interior in ((64, 128), (5, 300), (16384, 16384), (8, 16, 128),
                     (3, 5, 7), (512, 512, 512)):
        got = tuning.stencil_tile(interior, dtype)
        assert got == r_tuning.stencil_tile(interior, jdt)
        card = tuning.stencil_tile(interior, dtype, "cuda")
        assert len(card) == len(interior)
        assert all(1 <= t <= n for t, n in zip(card, interior))
