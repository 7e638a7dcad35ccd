"""Port vs reference: the batch-invariant decode kernels D1 (decode
attention) and R1 (router logits), and the chunked prefill's narrow
operands, on the CPU.

D1 (``kernels/flash_attention/csrc/decode_attention.cu``) and R1
(``kernels/router/csrc/router.cu``) run only on the card.  Held here:

* the plain versions (the CPU path of ``ops.decode_attention`` and of
  ``router_logits``) against the reference's ``decode_attention`` and
  ``route_tokens`` logits, at scalar, per-row and absent ``kv_len``, with
  and without a window;
* each kernel's order of operations, emulated in PyTorch
  (``ref.decode_attention_ordered``, ``router.ref.router_logits_ordered``;
  ``chip_smoke.py`` holds R1 ``torch.equal`` to its emulation on the card),
  within its stated tolerance of the reference, and its laws as
  ``torch.equal``: row i of B in {1, 2, 3, 4, 8, 16} rows == the row
  alone; D1 independent of the cache's capacity and of what lies past a
  row's length; a scalar ``kv_len`` == a vector of equal values;
* the dispatch rule, without a card: a tensor that is not on the CPU (a
  ``meta`` tensor here) never reaches a plain version -- it raises, at the
  missing compiler or on a dtype / head dim the kernel lacks -- and the
  wrappers' only calls of the plain versions sit in their CPU branch;
* ``chunked_attention``'s narrow branch (bf16 products with f32 outputs)
  against the widened one, and the CPU path unchanged.

Inputs come from numpy seeds; each tolerance is stated where it is used.
"""
import ast
import dataclasses
import importlib.util
import inspect
import os
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.kernels.flash_attention import ops as rfops
from repro.models import moe as rmoe

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.router import kernel as rk
from repro_torch.kernels.router import ref as rref
from repro_torch.models import layers, moe

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16
JNP = {F32: jnp.float32, BF16: jnp.bfloat16}
ROWS = (1, 2, 3, 4, 8, 16)
TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _t(a: np.ndarray, dt) -> torch.Tensor:
    return torch.from_numpy(a).to(dt)


def _j(a: np.ndarray, dt):
    return jnp.asarray(a).astype(JNP[dt])


def _decode_inputs(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    lens[0], lens[-1] = 1, S
    return q, k, v, lens


def _reference(q, k, v, lens, kind, window, qdt, cdt):
    """The reference's decode_attention on the same values and dtypes, as
    an f32 numpy array."""
    kv = {"vector": jnp.asarray(lens), "scalar": int(lens[1]),
          "none": None}[kind]
    out = rfops.decode_attention(_j(q, qdt), _j(k, cdt), _j(v, cdt),
                                 kv_len=kv, window=window)
    return np.asarray(out.astype(jnp.float32))


def _port_kv(lens, kind):
    return {"vector": torch.from_numpy(lens), "scalar": int(lens[1]),
            "none": None}[kind]


def _ulp_tol(want: np.ndarray, *dtypes) -> float:
    """One ulp at the largest |value| of the narrowest dtype in play (p is
    rounded to the cache dtype, the output to q's: a score summed in another
    order can round either to the neighbouring value), else 2e-6 of the
    largest |value| (f32 sums in another order)."""
    big = float(np.abs(want).max())
    if all(dt == F32 for dt in dtypes):
        return 2e-6 * big
    return 2.0 ** np.floor(np.log2(big)) * torch.finfo(BF16).eps


# ------------------------------------------------------- D1 plain version --

@pytest.mark.parametrize("kind", ["vector", "scalar", "none"])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("qdt,cdt", [(F32, F32), (BF16, BF16)])
def test_decode_plain_matches_reference(kind, window, qdt, cdt):
    """The CPU path of ``ops.decode_attention`` (D1's plain version, the
    port's body before D1) against the reference's ``decode_attention``,
    GQA 4/2, D 16, at per-row, scalar and absent ``kv_len``, within
    :func:`_ulp_tol`."""
    q, k, v, lens = _decode_inputs(0, 5, 4, 2, 24, 16)
    want = _reference(q, k, v, lens, kind, window, qdt, cdt)
    got = fops.decode_attention(_t(q, qdt), _t(k, cdt), _t(v, cdt),
                                kv_len=_port_kv(lens, kind), window=window)
    assert got.dtype == qdt
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want, qdt,
                                                                cdt)


# ----------------------------------------------------- D1 order emulated --

@pytest.mark.parametrize("D", [16, 64, 256])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("qdt,cdt", [(F32, F32), (BF16, BF16), (BF16, F32),
                                     (F32, BF16)])
def test_decode_order_matches_reference(D, window, qdt, cdt):
    """D1's order (``ref.decode_attention_ordered``: lanes over D, the
    butterfly, the global max, warps over positions, partials in warp
    order) against the reference at per-row ``kv_len``, within
    :func:`_ulp_tol`; a row with no visible position gives zeros (the
    kernel's value there)."""
    q, k, v, lens = _decode_inputs(1, 6, 4, 2, 40, D)
    want = _reference(q, k, v, lens, "vector", window, qdt, cdt)
    got = fref.decode_attention_ordered(_t(q, qdt), _t(k, cdt), _t(v, cdt),
                                        kv_len=torch.from_numpy(lens),
                                        window=window)
    assert got.dtype == qdt
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want, qdt,
                                                                cdt)
    empty = fref.decode_attention_ordered(
        _t(q, qdt), _t(k, cdt), _t(v, cdt),
        kv_len=torch.zeros(6, dtype=torch.int64), window=window)
    assert not empty.any()


@pytest.mark.parametrize("D,dt", [(16, F32), (64, BF16), (128, BF16),
                                  (256, BF16), (256, F32)])
def test_decode_order_rows_do_not_depend_on_the_batch(D, dt):
    """Row i of D1's order at B rows is ``torch.equal`` to row i alone,
    for every B in ROWS, at per-row lengths, with a window."""
    q, k, v, lens = _decode_inputs(2, max(ROWS), 4, 2, 36, D)
    q, k, v = _t(q, dt), _t(k, dt), _t(v, dt)
    kv = torch.from_numpy(lens)
    alone = [fref.decode_attention_ordered(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], kv_len=kv[i:i + 1],
                                           window=20)
             for i in range(max(ROWS))]
    for B in ROWS:
        out = fref.decode_attention_ordered(q[:B], k[:B], v[:B],
                                            kv_len=kv[:B], window=20)
        for i in range(B):
            assert torch.equal(out[i:i + 1], alone[i]), (B, i)


def test_decode_order_has_the_kernels_warp_count():
    """The emulation walks positions with the order constants the kernel's
    source declares: positions a chunk (``kChunk``), CTAs a cluster
    (``kCtas``) and warps a CTA (``kWarps``), the numbers the summation
    order depends on, and the shared score budget (``kScoreBytes``) past
    which pass 2 recomputes the scores."""
    src = open(os.path.join(os.path.dirname(fk.__file__), "csrc",
                            "decode_attention.cu")).read()
    for name, value in (("kChunk", fref.DECODE_CHUNK),
                        ("kCtas", fref.DECODE_CTAS),
                        ("kWarps", fref.DECODE_WARPS),
                        ("kScoreBytes", fref.DECODE_SCORE_BYTES)):
        decl = [ln.split("//")[0].strip() for ln in src.splitlines()
                if ln.startswith(f"constexpr int {name} = ")]
        assert decl == [f"constexpr int {name} = {value};"], name


@pytest.mark.parametrize("window", [None, 9])
def test_decode_order_ignores_the_capacity(window):
    """D1's order reads nothing past a row's length: the same rows in a
    cache of 30 and of 64 positions, with random values past every length
    in the larger one, give ``torch.equal`` outputs; a scalar ``kv_len`` is
    ``torch.equal`` to a vector of equal values, and None to the
    capacity."""
    q, k, v, lens = _decode_inputs(3, 5, 4, 2, 30, 64)
    lens[-1] = 29
    rng = np.random.default_rng(4)
    kb = rng.normal(size=(5, 2, 64, 64)).astype(np.float32)
    vb = rng.normal(size=(5, 2, 64, 64)).astype(np.float32)
    kb[:, :, :30], vb[:, :, :30] = k, v
    args = [_t(a, BF16) for a in (q, k, v)]
    big = [args[0], _t(kb, BF16), _t(vb, BF16)]
    kv = torch.from_numpy(lens)
    small = fref.decode_attention_ordered(*args, kv_len=kv, window=window)
    assert torch.equal(small, fref.decode_attention_ordered(
        *big, kv_len=kv, window=window))
    assert torch.equal(
        fref.decode_attention_ordered(*args, kv_len=17, window=window),
        fref.decode_attention_ordered(*args, kv_len=torch.full((5,), 17),
                                      window=window))
    assert torch.equal(
        fref.decode_attention_ordered(*args, window=window),
        fref.decode_attention_ordered(*args, kv_len=30, window=window))


# ------------------------------- D1 at head dim 192, GQA groups past 8 --

@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("qdt,cdt", [(F32, F32), (BF16, BF16), (BF16, F32),
                                     (F32, BF16)])
def test_decode_at_head_dim_192_group_12_matches_reference(window, qdt, cdt):
    """nemotron-4-340b's decode shape (head dim 192, GQA 12/1 and 24/2):
    the plain version and D1's order against the reference's
    ``decode_attention`` at per-row ``kv_len``, within :func:`_ulp_tol`."""
    for Hq, Hkv in ((12, 1), (24, 2)):
        q, k, v, lens = _decode_inputs(11, 5, Hq, Hkv, 40, 192)
        want = _reference(q, k, v, lens, "vector", window, qdt, cdt)
        args = (_t(q, qdt), _t(k, cdt), _t(v, cdt))
        kv = torch.from_numpy(lens)
        for got in (fops.decode_attention(*args, kv_len=kv, window=window),
                    fref.decode_attention_ordered(*args, kv_len=kv,
                                                  window=window)):
            assert got.dtype == qdt
            assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(
                want, qdt, cdt), (Hq, Hkv)


@pytest.mark.parametrize("D,group,dt", [(192, 12, BF16), (192, 12, F32),
                                        (192, 6, BF16), (128, 12, BF16),
                                        (64, 16, F32)])
def test_decode_order_of_a_head_does_not_depend_on_its_group(D, group, dt):
    """D1 takes a group past ``ref.DECODE_PASS_HEADS`` heads in passes,
    each pass a cluster of its own.  A head's order involves no other head,
    so its bits are the same in any group: the emulation at ``group``
    heads a kv head, ``torch.equal`` to each pass alone (heads 8 j .. 8 j +
    7 against the same kv head) and to each head alone (a group of 1)."""
    Hkv = 2
    q, k, v, lens = _decode_inputs(12, 3, group * Hkv, Hkv, 48, D)
    q, k, v = _t(q, dt), _t(k, dt), _t(v, dt)
    kv = torch.from_numpy(lens)
    whole = fref.decode_attention_ordered(q, k, v, kv_len=kv, window=30)
    P = fref.DECODE_PASS_HEADS
    for h in range(Hkv):
        for j in range(0, group, P):
            heads = slice(h * group + j, h * group + min(j + P, group))
            part = fref.decode_attention_ordered(
                q[:, heads].contiguous(), k[:, h:h + 1], v[:, h:h + 1],
                kv_len=kv, window=30)
            assert torch.equal(part, whole[:, heads]), (h, j)
        for i in range(group):
            head = h * group + i
            one = fref.decode_attention_ordered(
                q[:, head:head + 1], k[:, h:h + 1], v[:, h:h + 1],
                kv_len=kv, window=30)
            assert torch.equal(one, whole[:, head:head + 1]), head


@pytest.mark.parametrize("dt", [BF16, F32])
def test_decode_order_at_head_dim_192_group_12_rows_alone(dt):
    """Row i of D1's order at nemotron's head dim 192 and group 12 at B
    rows is ``torch.equal`` to row i alone, for every B in ROWS, at per-row
    lengths, with and without a window."""
    q, k, v, lens = _decode_inputs(13, max(ROWS), 12, 1, 36, 192)
    q, k, v = _t(q, dt), _t(k, dt), _t(v, dt)
    kv = torch.from_numpy(lens)
    for window in (None, 20):
        alone = [fref.decode_attention_ordered(
            q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_len=kv[i:i + 1],
            window=window) for i in range(max(ROWS))]
        for B in ROWS:
            out = fref.decode_attention_ordered(q[:B], k[:B], v[:B],
                                                kv_len=kv[:B], window=window)
            for i in range(B):
                assert torch.equal(out[i:i + 1], alone[i]), (window, B, i)


def test_decode_group_passes_match_the_source():
    """The heads a pass (``kGroupMax``) and the largest group
    (``kGroupLimit``) the kernel's source declares are the emulation's
    ``DECODE_PASS_HEADS`` and the wrapper's limit; the wrapper takes head
    dim 192 and refuses a group past the limit before any launch."""
    src = open(os.path.join(os.path.dirname(fk.__file__), "csrc",
                            "decode_attention.cu")).read()
    for name, value in (("kGroupMax", fref.DECODE_PASS_HEADS),
                        ("kGroupLimit", fk._DECODE_GROUP_MAX)):
        decl = [ln.split("//")[0].strip() for ln in src.splitlines()
                if ln.startswith(f"constexpr int {name} = ")]
        assert decl == [f"constexpr int {name} = {value};"], name
    assert 192 in fk._HEAD_DIMS and fk._DECODE_GROUP_MAX == 16
    assert "case 192:" in src


# ----------------------------------------------------- R1 order emulated --

def _router_inputs(seed, T, d, E):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, E)) * d ** -0.5).astype(np.float32)
    return x, w


def _reference_logits(x, w, xdt, wdt):
    """The reference's ``route_tokens`` logits (its f32 product) on x
    (T, d) as one row of T tokens."""
    cfg = dataclasses.replace(r_get_smoke("llama4-scout-17b-a16e"),
                              d_model=x.shape[1], n_experts=w.shape[1])
    r = rmoe.route_tokens(_j(w, wdt), _j(x, xdt)[None], cfg)
    return np.asarray(r.logits[0])


@pytest.mark.parametrize("d", [64, 200, 5120])
@pytest.mark.parametrize("xdt,wdt", [(BF16, F32), (F32, F32), (BF16, BF16)])
def test_router_plain_and_order_match_reference(d, xdt, wdt):
    """R1's plain version (the CPU path of ``router_logits``, the port's
    product before R1) and its order (``router_logits_ordered``: lanes
    stride d by 32, then the butterfly) against the reference's
    ``route_tokens`` logits, within 1e-5 of the largest |logit| (f32 sums
    in another order; d 200 leaves a ragged last lane step)."""
    x, w = _router_inputs(5, 9, d, 16)
    want = _reference_logits(x, w, xdt, wdt)
    tol = 1e-5 * np.abs(want).max()
    xt, wt = _t(x, xdt), _t(w, wdt)
    plain = rk.router_logits(xt, wt)
    assert torch.equal(plain, xt.float() @ wt.float())
    for got in (plain, rref.router_logits_ordered(xt, wt)):
        assert got.dtype == F32
        assert np.abs(got.numpy() - want).max() <= tol


@pytest.mark.parametrize("xdt", [BF16, F32])
def test_router_order_rows_do_not_depend_on_the_batch(xdt):
    """Row i of R1's order at B tokens is ``torch.equal`` to token i
    alone, for every B in ROWS, and as a (B, S, d) prefill-shaped call."""
    x, w = _router_inputs(6, max(ROWS), 640, 16)
    xt, wt = _t(x, xdt), _t(w, F32)
    alone = [rref.router_logits_ordered(xt[i:i + 1], wt)
             for i in range(max(ROWS))]
    for B in ROWS:
        out = rref.router_logits_ordered(xt[:B], wt)
        for i in range(B):
            assert torch.equal(out[i:i + 1], alone[i]), (B, i)
    prefill = rref.router_logits_ordered(xt.reshape(4, 4, 640), wt)
    assert torch.equal(prefill.reshape(16, 16), torch.cat(alone))


# ---------------------------------------------------- the dispatch rule --

def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_decode_attention_off_the_cpu_never_takes_the_plain_version(
        monkeypatch):
    """A non-CPU tensor goes to the kernel: with the plain version made to
    fail, ``ops.decode_attention`` on meta tensors raises at the missing
    compiler (the launch), never in the plain version; an unsupported
    dtype, head dim or GQA group raises before it."""
    def plain(*a, **kw):
        raise AssertionError("the plain decode attention ran")

    monkeypatch.setattr(fref, "decode_attention_ref", plain)
    monkeypatch.setattr(fk.build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    fk._decode_lib.cache_clear()
    cache = _meta(2, 2, 8, 64)
    for kv_len in (3, torch.empty(2, dtype=torch.int64, device="meta"),
                   None):
        with pytest.raises(FileNotFoundError):
            fops.decode_attention(_meta(2, 4, 1, 64), cache, cache,
                                  kv_len=kv_len, window=4)
    for q, c, err in ((_meta(2, 4, 1, 64, dtype=torch.float16),
                       _meta(2, 2, 8, 64, dtype=torch.float16), TypeError),
                      (_meta(2, 4, 1, 32), _meta(2, 2, 8, 32), ValueError),
                      (_meta(2, 34, 1, 64), cache, ValueError)):
        with pytest.raises(err):
            fops.decode_attention(q, c, c, kv_len=3)
    fk._decode_lib.cache_clear()


def test_router_logits_off_the_cpu_never_takes_the_plain_version(
        monkeypatch):
    """As above for R1 through ``moe.route_tokens``' entry
    ``router_logits``: meta tensors raise at the missing compiler, float16
    raises before it, the plain product never runs."""
    def plain(*a, **kw):
        raise AssertionError("the plain router product ran")

    monkeypatch.setattr(rk, "router_logits_ref", plain)
    monkeypatch.setattr(rk.build, "nvcc_path", lambda: (_ for _ in ()).throw(
        FileNotFoundError("no nvcc")))
    rk._lib.cache_clear()
    with pytest.raises(FileNotFoundError):
        rk.router_logits(_meta(2, 3, 64, dtype=BF16), _meta(64, 16))
    with pytest.raises(TypeError):
        rk.router_logits(_meta(2, 3, 64, dtype=torch.float16), _meta(64, 16))
    rk._lib.cache_clear()


def _plain_calls(fn, names):
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
    (fk.decode_attention, {"decode_attention_ref"}, "q1"),
    (rk.router_logits, {"router_logits_ref"}, "x"),
    (fops.decode_attention, {"decode_attention_ref"}, None),
    (moe.route_tokens, {"router_logits_ref"}, None),
])
def test_plain_versions_are_reached_from_the_cpu_branch_only(
        fn, names, device_of):
    """By inspection: each wrapper calls its plain version only inside
    ``if <tensor>.device.type == "cpu"``, and the callers on the serving
    path (``ops.decode_attention``, ``moe.route_tokens``) never call it."""
    calls = _plain_calls(fn, names)
    if device_of is None:
        assert calls == []
    else:
        assert calls and all(
            f"{device_of}.device.type == 'cpu'" in tests
            for _, tests in calls), calls


# ------------------------------------------------- chunked, narrow operands --

def _parent_chunked():
    """The f32-widened chunked attention that ``tools/compare_chunked.py``
    keeps as its yardstick (the port's version before its operands were
    kept narrow)."""
    spec = importlib.util.spec_from_file_location(
        "compare_chunked", os.path.join(TOOLS, "compare_chunked.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.chunked_attention_f32


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("window", [None, 11])
def test_chunked_cpu_path_is_unchanged(dt, window):
    """On the CPU ``chunked_attention`` keeps the widened products: its
    output is ``torch.equal`` to the f32-widened version's, GQA 4/2,
    ragged chunks."""
    rng = np.random.default_rng(7)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), dt) for s in
               ((2, 4, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16)))
    want = _parent_chunked()(q, k, v, window=window, chunk=16)
    got = layers.chunked_attention(q, k, v, window=window, chunk=16)
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 11])
def test_chunked_narrow_branch_matches_widened(monkeypatch, window):
    """The narrow branch (what runs on the card for bf16: ``torch.bmm`` on
    bf16 operands with f32 outputs) taken on the CPU, with ``bmm``'s
    ``out_dtype`` computed as an f32 product of the widened operands
    (exact products; the CPU has no ``bmm.dtype`` kernel): within one
    bf16 ulp at the largest |value| of the widened path (the two sum in
    other orders, and the output is rounded to bf16).  The shapes and
    views of the branch are what this holds."""
    bmm = torch.bmm
    narrow_calls = []

    def bmm_out(a, b, *, out_dtype=None):
        assert a.dtype == b.dtype == BF16 and out_dtype == F32
        narrow_calls.append(1)
        return bmm(a.float(), b.float())

    rng = np.random.default_rng(8)
    q, k, v = (_t(rng.normal(size=s).astype(np.float32), BF16) for s in
               ((2, 4, 37, 16), (2, 2, 37, 16), (2, 2, 37, 16)))
    want = layers.chunked_attention(q, k, v, window=window, chunk=16)
    monkeypatch.setattr(layers, "_narrow_operands", lambda t: True)
    monkeypatch.setattr(torch, "bmm", bmm_out)
    got = layers.chunked_attention(q, k, v, window=window, chunk=16)
    assert narrow_calls and len(narrow_calls) == 2 * 3
    assert got.dtype == BF16
    big = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() \
        <= 2.0 ** np.floor(np.log2(big)) * torch.finfo(BF16).eps
