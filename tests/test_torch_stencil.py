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
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.stencils import STENCILS as R_STENCILS
from repro.kernels.stencil import ops as r_ops
from repro.kernels import tuning as r_tuning
from repro.kernels.stencil.ref import stencil_ref as r_stencil_ref

from repro_torch.core.stencils import STENCILS, StencilSpec
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


# ---------------------------------------------------------------------------
# K6b's march (``march_kernel`` of ``csrc/stencil.cu``), pinned on the CPU:
# which specs take it, its compiled tap tables against the specs, and a
# plain-torch emulation of its traversal.

_CU = (Path(kernel.__file__).parent / "csrc" / "stencil.cu").read_text()


def _cu_const(name):
    m = re.search(rf"constexpr int {name} = (\d+);", _CU)
    assert m, name
    return int(m.group(1))


def _cu_pattern(struct):
    """The (dz, dy, dx) rows of a pattern struct's ``off`` table, in the
    source's order."""
    body = re.search(rf"struct {struct} \{{.*?off\[n\]\[3\] = \{{(.*?)\}};",
                     _CU, re.S)
    assert body, struct
    return tuple(tuple(int(v) for v in t.split(","))
                 for t in re.findall(r"\{([-\d, ]+)\}", body.group(1)))


def test_march_constants_match_source():
    """The wrapper's geometry uses the source's constants."""
    assert (kernel.RUN_X, kernel.RING, kernel.MARCH_THREADS) == (
        _cu_const("kRunX"), _cu_const("kRing"), _cu_const("kMarchThreads"))
    assert kernel.RUN_X == 4 and kernel.RING >= 4


@pytest.mark.parametrize("struct,name,code", [("Box27", "j3d27pt", 1),
                                              ("Star7", "j3d7pt", 2)])
def test_march_tap_tables_are_spec_order(struct, name, code):
    """The compiled tap tables list the spec's taps in its own order, so
    each output's chain runs as the plain version's does."""
    spec = STENCILS[name]
    table = _cu_pattern(struct)
    assert table == tuple(tuple(o) for o in spec.offsets)
    pattern = kernel.pattern_of(spec)
    assert kernel.PATTERNS[pattern] == (code, table)
    assert re.search(rf"pattern == {code} \? {struct}::n", _CU)


_BOX = tuple(itertools.product((-1, 0, 1), repeat=3))
_CUSTOM = {
    "j3d27pt": (STENCILS["j3d27pt"].offsets, "box"),
    "j3d7pt": (STENCILS["j3d7pt"].offsets, "star"),
    "box reversed": (_BOX[::-1], None),
    "star, z and y swapped": (STENCILS["j3d7pt"].offsets[:1]
                              + STENCILS["j3d7pt"].offsets[3:5]
                              + STENCILS["j3d7pt"].offsets[1:3]
                              + STENCILS["j3d7pt"].offsets[5:], None),
    "box less a corner": (_BOX[:-1], None),
    "star radius 2": (((0, 0, 0), (-2, 0, 0), (2, 0, 0), (0, -2, 0),
                       (0, 2, 0), (0, 0, -2), (0, 0, 2)), None),
}


@pytest.mark.parametrize("case", list(_CUSTOM))
def test_pattern_of(case):
    """Only a spec whose taps equal a compiled pattern's, in order, takes
    the march; a reordered or other 3-D spec (and any 2-D one) takes the
    general kernel."""
    offsets, want = _CUSTOM[case]
    spec = StencilSpec(case, 3, tuple(offsets),
                       tuple(0.01 * (k + 1) for k in range(len(offsets))))
    assert kernel.pattern_of(spec) == want
    assert kernel.pattern_of(STENCILS["j2d9pt"]) is None


def test_march_tiles_fit():
    """The card's default tiles fit their kernels: the march's within its
    threads and shared memory, the general kernel's within 48 KB."""
    for dtype in (torch.float32, torch.bfloat16):
        tile = tuning.stencil_tile((512, 512, 512), dtype, "cuda")
        threads, smem = kernel.march_geometry(tile)
        assert threads <= kernel.MARCH_THREADS and smem <= 48 * 1024
        tz, ty, tx = tuning.stencil_tile((512, 512, 512), dtype, "cuda",
                                         general=True)
        assert 4 * (tz + 2) * (ty + 2) * (tx + 2) <= 48 * 1024
    assert kernel.march_geometry((2, 4, 32)) == (32, 4 * 4 * 6 * 36)
    assert kernel.march_geometry((2, 4, 32), 2) == (32, 2 * 4 * 6 * 36)


def _march_emulate(grid, spec, tile, land):
    """The march as ``march_kernel`` runs it, one block at a time, all of
    a block's threads at once: window cells staged by the threads' own
    loops from the flat grid into a ring of RING plane buffers in the
    grid's type (element pairs where the block's rows start on two
    elements, else single elements; a ``cp.async`` group a plane, landing
    at issue or only at the wait that covers it, bf16 single elements at
    once), each thread's three rows of a new plane read as columns 4 txi
    .. 4 txi + 7 into three rotating register slots, the taps applied from
    the slots in the compiled order, ragged outputs not stored.  Returns
    the output, the grid element each stored output met at each tap, the
    byte offsets (mod 16) at which the grid rows it staged start, and the
    staging paths its blocks took."""
    R, RUN = kernel.RING, kernel.RUN_X
    taps = _cu_pattern({"box": "Box27", "star": "Star7"}[
        kernel.pattern_of(spec)])
    coeffs = spec.coeffs_f32()
    GZ, GY, GX = grid.shape
    Z, Y, X = GZ - 2, GY - 2, GX - 2
    tz, ty, tx = tile
    nthx = -(-tx // RUN)
    sx = RUN * nthx + 4
    flat = grid.reshape(-1)
    out = torch.full((Z, Y, X), float("nan"), dtype=grid.dtype)
    met = torch.full((Z, Y, X, len(taps)), -1, dtype=torch.long)
    starts, paths = set(), set()
    tyi = torch.arange(ty)[:, None]
    txi = torch.arange(nthx)[None, :]
    rows_of = tyi[:, :, None] + torch.arange(3)[None, None, :]
    cols_of = RUN * txi[:, :, None] + torch.arange(8)[None, None, :]
    for z0 in range(0, Z, tz):
        for y0 in range(0, Y, ty):
            for x0 in range(0, X, tx):
                nz, rows, cols = min(tz, Z - z0), min(ty + 2, GY - y0), \
                    min(tx + 2, GX - x0)
                corner = z0 * GY * GX + y0 * GX + x0
                pairs = GX % 2 == 0 and corner % 2 == 0
                paths.add("pairs" if pairs else "single")
                ring_v = torch.full((R, ty + 2, sx), float("nan"))
                ring_i = torch.full((R, ty + 2, sx), -1, dtype=torch.long)
                pending = []

                def cells():
                    """(r, c) each thread copies, by its loops; a pair's
                    column past the window, as c = cols, reads nothing."""
                    if pairs:
                        got = [(r, c) for t in range(ty) for s in range(nthx)
                               for r in range(t, rows, ty)
                               for c2 in range(s, (cols + 1) // 2, nthx)
                               for c in (2 * c2, 2 * c2 + 1)]
                    else:
                        got = [(r, c) for t in range(ty) for s in range(nthx)
                               for r in range(t, rows, ty)
                               for c in range(s, cols, nthx)]
                    assert sorted(got) == [(r, c) for r in range(rows)
                                           for c in range(cols + cols % 2
                                                          * pairs)]
                    return got

                def stage(p):
                    if p >= nz + 2:
                        pending.append(None)
                        return
                    got = []
                    for r, c in cells():
                        f = corner + p * GY * GX + r * GX + c
                        got.append((r, c, 0.0, -1) if c == cols
                                   else (r, c, float(flat[f]), f))
                    for r in range(rows):
                        starts.add((corner - x0 + p * GY * GX + r * GX)
                                   * grid.element_size() % 16)
                    pending.append((p % R, got))
                    if land == "issue" or not (pairs or
                                               grid.dtype == torch.float32):
                        put(pending.pop())
                        pending.append(None)

                def put(group):
                    if group is not None:
                        b, got = group
                        for r, c, v, f in got:
                            ring_v[b, r, c], ring_i[b, r, c] = v, f

                def wait(n):
                    while len(pending) > n:
                        put(pending.pop(0))

                def load(p):
                    b = p % R
                    at = (rows_of[..., None], cols_of[:, :, None])
                    return ring_v[b][at], ring_i[b][at]

                for p in range(R):
                    stage(p)
                wait(R - 2)
                q = [load(0), load(1), None]
                for j in range(nz):
                    rot = j % 3
                    wait(R - 3)
                    stage(j + R)
                    q[(rot + 2) % 3] = load(j + 2)
                    acc = torch.zeros((ty, nthx, RUN))
                    seen = []
                    for (dz, dy, dx), c in zip(taps, coeffs):
                        v, i = q[(rot + dz + 1) % 3]
                        acc = acc + c * v[:, :, dy + 1, dx + 1:dx + 1 + RUN]
                        seen.append(i[:, :, dy + 1, dx + 1:dx + 1 + RUN])
                    seen = torch.stack(seen, -1)
                    for t in range(ty):
                        for s in range(nthx):
                            y = y0 + t
                            n = min(RUN, min(tx, X - x0) - RUN * s)
                            if y >= Y or n <= 0:
                                continue
                            xs = x0 + RUN * s
                            dst = out[z0 + j, y, xs:xs + n]
                            assert bool(dst.isnan().all()), "stored twice"
                            dst.copy_(acc[t, s, :n].to(grid.dtype))
                            met[z0 + j, y, xs:xs + n] = seen[t, s, :n]
    return out, met, starts, paths


def _expected_taps(shape, spec):
    Z, Y, X = shape
    GY, GX = Y + 2, X + 2
    z, y, x = torch.meshgrid(torch.arange(Z), torch.arange(Y),
                             torch.arange(X), indexing="ij")
    return torch.stack([(z + 1 + dz) * GY * GX + (y + 1 + dy) * GX
                        + x + 1 + dx for dz, dy, dx in spec.offsets], -1)


# interior, tile, the f32 grid rows' byte offsets mod 16, the staging
# paths: ragged in every dim, tz below the ring, a one-block tile, a
# one-row block of one thread along x, runs cut short in x, an odd window
# width copied in pairs; X + 2 = 10 puts rows 0 or 8 bytes off 16 (as the
# library's 514 does), odd X + 2 any 4 bytes, 8 and 12 none.
_MARCH_CASES = [((5, 6, 9), (2, 4, 8), {0, 4, 8, 12}, {"single"}),
                ((7, 9, 13), (3, 4, 8), {0, 4, 8, 12}, {"single"}),
                ((6, 5, 8), (6, 5, 8), {0, 8}, {"pairs"}),
                ((4, 3, 5), (1, 1, 4), {0, 4, 8, 12}, {"single"}),
                ((9, 4, 6), (4, 2, 3), {0}, {"pairs", "single"}),
                ((5, 7, 10), (2, 3, 5), {0}, {"pairs", "single"})]


@pytest.mark.parametrize("shape,tile,row_starts,paths", _MARCH_CASES)
@pytest.mark.parametrize("name", ["j3d27pt", "j3d7pt"])
@pytest.mark.parametrize("dtype,land", [(torch.float32, "issue"),
                                        (torch.float32, "wait"),
                                        (torch.bfloat16, "wait")])
def test_march_traversal_emulated(shape, tile, row_starts, paths, name,
                                  dtype, land):
    """Every output of the emulated march is stored once, meets exactly
    its own taps in spec order, and equals the plain version bit for bit,
    whether a staged plane lands at once or only at its wait."""
    spec = STENCILS[name]
    g = np.random.default_rng(sum(shape) + len(name)).standard_normal(
        tuple(n + 2 for n in shape)).astype(np.float32)
    grid = torch.from_numpy(g).to(dtype)
    out, met, starts, took = _march_emulate(grid, spec, tile, land)
    assert torch.equal(met, _expected_taps(shape, spec))
    assert torch.equal(out, kernel.stencil_ref(grid, spec))
    assert took == paths
    if dtype == torch.float32:
        assert starts == row_starts
