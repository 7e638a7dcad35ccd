"""R1's tiles and traversal (``kernels/router/csrc/router.cu``) on the CPU.

R1 runs only on the card.  Held here:

* the tile rule ``tuning.router_tiles``: every tile it gives is one the
  source instantiates, its blocks cover each (token, expert) exactly once,
  and at 1,024 tokens and more it fills the card with blocks;
* the wrapper hands the rule's tile to the launcher (a fake library in
  place of the built one, ``meta`` tensors) and asks for the SM count only
  after the library has loaded;
* the source against the order it must keep: no FMA intrinsic, every term
  a ``__fmul_rn`` then a ``__fadd_rn``, the lane stride and butterfly
  offsets of ``router.ref.router_logits_ordered``, and the instance set of
  ``tuning``;
* both kernels' traversal emulated in plain torch at their tiles (warps
  over tokens and experts, each lane's chain with the zero terms past d,
  the transposing butterfly and the lane each result is stored from):
  ``torch.equal`` to ``router_logits_ordered`` and within 1e-5 of the
  reference's ``route_tokens`` logits.

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""
import dataclasses
import inspect
import os
import re
import types

import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.models import moe as rmoe
import jax.numpy as jnp

from repro_torch.kernels import build, tuning
from repro_torch.kernels.router import kernel as rk
from repro_torch.kernels.router import ref as rref

torch.set_num_threads(2)

SMS = 132                       # an H100's SM count
SRC = os.path.join(os.path.dirname(rk.__file__), "csrc", "router.cu")
CHUNK = 128                     # the many-token kernel's W rows a chunk
FEW_BATCH = {4: 32, 2: 16}      # few-token kernel's steps a batch, by W's size
TOKENS = sorted({*range(1, 70), *range(120, 140), 255, 256, 257, 999, 1000,
                 1023, 1024, 1025, 2047, 2048, 4095, 4096, 8191, 8192, 8193,
                 12345, 16383, 16384} | {int(t) for t in np.random.default_rng(
                     0).integers(1, 16385, 64)})


def _code() -> str:
    """The source with its comments removed."""
    src = open(SRC).read()
    return re.sub(r"//[^\n]*", "", src)


def _valid(tiles: tuning.RouterTiles) -> bool:
    if tiles.staged:
        return (tiles.tokens, tiles.experts) in tuning.ROUTER_MANY_TILES
    return (tiles.tokens in tuning.ROUTER_FEW_WARPS
            and tiles.experts in tuning.ROUTER_FEW_EXPERTS)


def _warps(T, E, tiles):
    """Every warp of the launch as (token index, expert index) tensors of
    shapes (warps, tokens a warp) and (warps, experts a warp), as the
    kernels compute them from the block and warp index."""
    gx, gy = tuning.router_grid(T, E, tiles)
    warps, tpw = tuning.router_warps(tiles)
    bx, by, w = torch.meshgrid(torch.arange(gx), torch.arange(gy),
                               torch.arange(warps), indexing="ij")
    bx, by, w = bx.reshape(-1), by.reshape(-1), w.reshape(-1)
    ec = tiles.experts
    tok = (bx * warps + w)[:, None] * tpw + torch.arange(tpw)
    exp = (by * ec)[:, None] + torch.arange(ec)
    return tok, exp


# ------------------------------------------------------------ the rule --

@pytest.mark.parametrize("E", [5, 16, 128])
def test_router_tiles_come_from_the_instantiated_set(E):
    """For T in 1..16,384 (every T to 69, edges of each regime and 64
    sampled), the rule gives a tile the launcher takes: the few-token
    kernel up to ``ROUTER_FEW_TOKENS`` tokens, its experts a warp dividing
    E (W read in whole groups), the many-token one above."""
    for T in TOKENS:
        tiles = tuning.router_tiles(T, E, SMS)
        assert _valid(tiles), (T, E, tiles)
        assert tiles.staged or E % tiles.experts == 0, (T, E, tiles)
        assert tiles.staged == (T > tuning.ROUTER_FEW_TOKENS), (T, tiles)


@pytest.mark.parametrize("E", [5, 16, 128])
@pytest.mark.parametrize("T", [1, 3, 4, 8, 63, 64, 65, 130, 1000, 1024,
                               4097, 8192])
def test_router_blocks_cover_each_pair_once(T, E):
    """The rule's grid, at the kernels' index arithmetic, takes each
    (token, expert) of T x E exactly once; the rest of its warps' slots lie
    past T or past E (the kernels store nothing there)."""
    tiles = tuning.router_tiles(T, E, SMS)
    tok, exp = _warps(T, E, tiles)
    t = tok[:, :, None].expand(-1, -1, exp.shape[1])
    e = exp[:, None, :].expand(-1, tok.shape[1], -1)
    keep = (t < T) & (e < E)
    hits = torch.bincount((t[keep] * E + e[keep]), minlength=T * E)
    assert hits.shape[0] == T * E and bool((hits == 1).all())


def test_router_grid_fills_the_card():
    """At 1,024 tokens and more (E 16), at least 128 blocks (a wave of the
    card's SMs, at most one in 32 idle): 1,024 and 8,192 tokens, a 4 x 256
    and a 4 x 2048 prefill, take 128, the first as 2 tokens a warp by 8
    experts a block, the second as 8 by 16; a decode step of 4 tokens
    takes 32 blocks of the few-token kernel."""
    for T in [t for t in TOKENS if t >= 1024]:
        gx, gy = tuning.router_grid(T, 16, tuning.router_tiles(T, 16, SMS))
        assert gx * gy >= 128, T
    assert tuning.router_tiles(1024, 16, SMS) == (1, 2, 8)
    assert tuning.router_tiles(8192, 16, SMS) == (1, 8, 16)
    for T in (1024, 8192):
        tiles = tuning.router_tiles(T, 16, SMS)
        assert np.prod(tuning.router_grid(T, 16, tiles)) == 128
    gx, gy = tuning.router_grid(4, 16, tuning.router_tiles(4, 16, SMS))
    assert gx * gy == 32


@pytest.mark.parametrize("T,E,sms", [(0, 16, SMS), (4, 0, SMS),
                                     (4, 65536, SMS), (4, 16, 0)])
def test_router_tiles_refuse_what_no_launch_takes(T, E, sms):
    with pytest.raises(ValueError):
        tuning.router_tiles(T, E, sms)


# ------------------------------------------------------- the wrapper --

class _FakeLib:
    """Records ``router_launch``'s arguments; returns ``err``."""

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def router_launch(self, *args):
        self.calls.append(args)
        return self.err

    def kernel_error_string(self, err):
        return b"invalid argument"


def _fake_card(monkeypatch, lib):
    monkeypatch.setattr(rk, "_lib", lambda: lib)
    monkeypatch.setattr(rk, "_sms", lambda index: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=7))


@pytest.mark.parametrize("shape", [(1, 1, 256), (4, 1, 256), (2, 32, 256),
                                   (65, 256), (4, 256, 256),
                                   (4, 2048, 256)])
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_router_wrapper_passes_the_rules_tiles(monkeypatch, shape, xdt,
                                               wdt):
    """Off the CPU, ``router_logits`` launches once, with T = the tokens of
    x, d, E, the dtype codes and the rule's tile for T and E at the card's
    SM count, on the current stream; the output is (..., E) f32."""
    lib = _FakeLib()
    _fake_card(monkeypatch, lib)
    x = torch.empty(shape, dtype=xdt, device="meta")
    w = torch.empty((256, 16), dtype=wdt, device="meta")
    before = rk.router_logits.launches
    out = rk.router_logits(x, w)
    T = int(np.prod(shape[:-1]))
    assert out.shape == (*shape[:-1], 16) and out.dtype == torch.float32
    assert rk.router_logits.launches == before + 1
    (call,) = lib.calls
    assert call[3:] == (T, 256, 16, rk._DTYPE_CODE[xdt], rk._DTYPE_CODE[wdt],
                        *tuning.router_tiles(T, 16, SMS), 7)


def test_router_wrapper_raises_on_a_refused_launch(monkeypatch):
    """A nonzero return of the launcher raises, and counts no launch."""
    _fake_card(monkeypatch, _FakeLib(err=1))
    before = rk.router_logits.launches
    with pytest.raises(RuntimeError, match="router launch"):
        rk.router_logits(torch.empty((4, 64), device="meta"),
                         torch.empty((64, 16), device="meta"))
    assert rk.router_logits.launches == before


def test_router_wrapper_loads_the_library_before_any_device_query(
        monkeypatch):
    """Without a compiler the wrapper raises at the build, before it asks
    the device for its SM count."""
    def no_query(index):
        raise AssertionError("the SM count was asked for first")

    monkeypatch.setattr(rk, "_sms", no_query)
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    rk._lib.cache_clear()
    with pytest.raises(FileNotFoundError):
        rk.router_logits(torch.empty((4, 64), dtype=torch.bfloat16,
                                     device="meta"),
                         torch.empty((64, 16), device="meta"))
    rk._lib.cache_clear()


# -------------------------------------------------------- the source --

def test_router_source_has_no_fma():
    """The order forbids contraction: no FMA intrinsic anywhere in the
    code, every term is ``__fadd_rn(acc, __fmul_rn(x, w))`` through
    ``term``, every running sum is updated through ``term`` or the
    butterfly's ``__fadd_rn``, and the build asks for no fast math."""
    code = _code()
    assert re.search(r"fma", code, re.IGNORECASE) is None
    assert "return __fadd_rn(acc, __fmul_rn(x, w));" in code
    updates = re.findall(r"\b(acc\[[^\]]*\]|v\[[^\]]*\])\s*=\s*([^;]*);",
                         code)
    assert updates
    for lhs, rhs in updates:
        assert rhs.startswith(("term(", "__fadd_rn(", "0.f")), (lhs, rhs)
    assert not any("fast" in f or "fmad" in f for f in build.NVCC_FLAGS)


def test_router_source_keeps_the_emulated_order():
    """The lane stride and the butterfly offsets the source declares are
    those of ``router_logits_ordered``: lanes of 32 over d, then xor 16, 8,
    4, 2, 1."""
    code = _code()
    assert re.findall(r"constexpr int kLaneStride = (\d+);", code) == ["32"]
    offsets = re.findall(r"constexpr int kButterfly\[5\] = \{([^}]*)\};",
                         code)
    assert [tuple(int(v) for v in o.split(",")) for o in offsets] == [
        (16, 8, 4, 2, 1)]
    ordered = inspect.getsource(rref.router_logits_ordered)
    assert "for o in (16, 8, 4, 2, 1):" in ordered
    assert "xt.reshape(xt.shape[0], -1, 32)" in ordered
    # every lane index steps by the stride, none by a literal
    assert "kLaneStride * g" in code and "kLaneStride * j" in code
    assert "i0 += kLaneStride * G" in code


def test_router_source_instantiates_the_rules_tiles():
    """The launcher's instance lists and warp bounds are ``tuning``'s."""
    code = _code()
    many = re.search(r"#define R1_MANY_TILES\(X\)(.*?)\n\s*#define",
                     code, re.S).group(1)
    pairs = {tuple(int(v) for v in m) for m in
             re.findall(r"X\((\d+), (\d+)\)", many)}
    assert pairs == set(tuning.ROUTER_MANY_TILES)
    few = re.search(r"#define R1_FEW_EXPERTS\(X\)([^\n]*)", code).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", few)) == \
        tuning.ROUTER_FEW_EXPERTS
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", code))
    assert int(consts["kManyWarps"]) == tuning.router_warps(
        tuning.RouterTiles(1, 1, 4))[0]
    assert max(tuning.ROUTER_FEW_WARPS) == int(consts["kMaxWarps"])
    assert int(consts["kDC"]) == CHUNK
    assert "constexpr int G = sizeof(Tw) == 4 ? {} : {};".format(
        FEW_BATCH[4], FEW_BATCH[2]) in code


_C_ARG = {"const void*": "c_void_p", "void*": "c_void_p",
          "float*": "c_void_p", "int": "c_int"}


def test_router_binding_matches_the_launcher():
    """``kernel.bind`` gives ``router_launch`` one ctypes argument for each
    parameter of the source's ``router_launch``, of its kind (a pointer or
    an int): the tile is three ints."""
    sig = re.search(r"int router_launch\(([^)]*)\)", _code()).group(1)
    params = [re.sub(r"\s+", " ", p).strip().rsplit(" ", 1)
              for p in sig.split(",")]
    want = [_C_ARG[kind.replace(" *", "*")] for kind, _ in params]
    lib = types.SimpleNamespace(router_launch=types.SimpleNamespace(),
                                kernel_error_string=types.SimpleNamespace())
    rk.bind(lib)
    assert [t.__name__ for t in lib.router_launch.argtypes] == want
    assert [name for _, name in params][-4:] == [
        "staged", "tokens", "experts", "stream"]


# ---------------------------------------------------- the traversal --

def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """The kernels' transposing butterfly on (warps, 32 lanes, N sums):
    at xor O a lane with bit O set keeps the upper half of its live sums
    and sends the lower, its partner the other way round."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        live = v.shape[2]
        if live > 1:
            h = live // 2
            up = ((lanes & o) != 0)[None, :, None]
            send = torch.where(up, v[:, :, :h], v[:, :, h:])
            keep = torch.where(up, v[:, :, h:], v[:, :, :h])
            v = keep + send[:, lanes ^ o]
        else:
            v = v + v[:, lanes ^ o]
    return v


def _emulate(x: torch.Tensor, w: torch.Tensor,
             tiles: tuning.RouterTiles) -> torch.Tensor:
    """R1's traversal at ``tiles`` in plain torch (f32 elementwise ops,
    each rounded): each warp's lanes sum their terms over d = l, l + 32,
    ..., padded with zero terms as the kernel runs them (to whole chunks of
    128 rows on the many-token kernel, to whole batches of G steps on the
    few-token one), then the transposing butterfly, and each result stored
    from the lane and slot the kernel stores it from.  Every (token,
    expert) must be stored exactly once."""
    T, d = x.shape
    E = w.shape[1]
    xf, wf = x.float(), w.float()
    tok, exp = _warps(T, E, tiles)
    tpw, ec = tok.shape[1], exp.shape[1]
    n = tpw * ec
    lanes = torch.arange(32)
    if tiles.staged:
        count = torch.full((32,), -(-d // CHUNK) * CHUNK // 32)
    else:
        g = FEW_BATCH[w.element_size()]
        count = torch.full((32,), -(-d // (32 * g)) * g)
    steps = int(count.max())
    nw, pad = tok.shape[0], 32 * steps - d
    xg = torch.where((tok < T)[:, :, None], xf[tok.clamp(max=T - 1)], 0.0)
    wg = torch.where((exp < E)[:, :, None],
                     wf[:, exp.clamp(max=E - 1)].permute(1, 2, 0), 0.0)
    xg = torch.nn.functional.pad(xg, (0, pad)).reshape(nw, tpw, steps, 32)
    wg = torch.nn.functional.pad(wg, (0, pad)).reshape(nw, ec, steps, 32)
    acc = torch.zeros((nw, 32, n))
    for k in range(steps):
        prod = (xg[:, :, None, k] * wg[:, None, :, k]).reshape(nw, n, 32)
        acc = torch.where((k < count)[None, :, None],
                          acc + prod.transpose(1, 2), acc)
    v = _butterfly(acc)
    out = torch.zeros((T, E))
    hits = torch.zeros((T, E), dtype=torch.int64)
    for lane in range(32):
        if n >= 32:
            items = [(k + (n // 32) * lane, k) for k in range(n // 32)]
        elif lane % (32 // n) == 0:
            items = [(lane // (32 // n), 0)]
        else:
            items = []
        for item, slot in items:
            t, e = tok[:, item // ec], exp[:, item % ec]
            keep = (t < T) & (e < E)
            out[t[keep], e[keep]] = v[keep, lane, slot]
            hits[t[keep], e[keep]] += 1
    assert bool((hits == 1).all())
    return out


ROUTER_CASES = [
    # (T, d, E, tile): the rule's tiles at small shapes, and the others
    (3, 200, 16, None), (9, 64, 16, None), (70, 200, 16, None),
    (40, 1000, 5, None), (3, 70, 3, None),
    (9, 200, 16, tuning.RouterTiles(0, 8, 1)),
    (9, 200, 16, tuning.RouterTiles(0, 2, 2)),
    (9, 3100, 16, tuning.RouterTiles(0, 4, 2)),
    (37, 300, 16, tuning.RouterTiles(1, 8, 16)),
    (37, 300, 16, tuning.RouterTiles(1, 4, 8)),
    (37, 300, 5, tuning.RouterTiles(1, 2, 4)),
    (37, 130, 16, tuning.RouterTiles(1, 1, 16)),
    # llama4-maverick's 128 experts at the rule's tiles: the few-token
    # kernel at a decode step's 4 and 8 tokens, the many-token one at the
    # 4 x 256 and 4 x 2048 prefills (d narrowed: the tile depends on T, E)
    (4, 64, 128, None), (8, 64, 128, None), (1024, 64, 128, None),
    (8192, 64, 128, None),
]


@pytest.mark.parametrize("T,d,E,tiles", ROUTER_CASES)
@pytest.mark.parametrize("xdt,wdt", [(torch.bfloat16, torch.float32),
                                     (torch.float32, torch.bfloat16)])
def test_router_traversal_is_the_emulated_order(T, d, E, tiles, xdt, wdt):
    """The kernels' traversal, emulated at their tiles (the rule's at 3-70
    tokens, and each kernel at other tiles), is ``torch.equal`` to
    ``router_logits_ordered``: the zero terms past d change no sum and the
    transposing butterfly adds the butterfly's pairs."""
    rng = np.random.default_rng(T * 7 + d)
    x = torch.from_numpy(rng.normal(size=(T, d)).astype(np.float32)).to(xdt)
    w = torch.from_numpy((rng.normal(size=(d, E)) * d ** -0.5).astype(
        np.float32)).to(wdt)
    tiles = tiles or tuning.router_tiles(T, E, SMS)
    assert torch.equal(_emulate(x, w, tiles),
                       rref.router_logits_ordered(x, w))


@pytest.mark.parametrize("tiles", [tuning.RouterTiles(0, 1, 2),
                                   tuning.RouterTiles(1, 8, 16)])
def test_router_traversal_matches_the_reference(tiles):
    """The emulated traversal against the reference's ``route_tokens``
    logits (its f32 product) on a (2, 5, 640) bf16 hidden state and an f32
    router: within 1e-5 of the largest |logit| (f32 sums in another
    order)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 640)).astype(np.float32)
    w = (rng.normal(size=(640, 16)) * 640 ** -0.5).astype(np.float32)
    cfg = dataclasses.replace(r_get_smoke("llama4-scout-17b-a16e"),
                              d_model=640, n_experts=16)
    want = np.asarray(rmoe.route_tokens(
        jnp.asarray(w), jnp.asarray(x).astype(jnp.bfloat16), cfg).logits)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(10, 640)
    got = _emulate(xt, torch.from_numpy(w), tiles).reshape(2, 5, 16)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
