"""The serving steps on a mesh (``launch.steps.make_prefill_step`` /
``make_serve_step`` / ``abstract_cache``) on gloo ranks on the CPU, vs the
reference's jitted sharded steps and vs the port's one-device
``model.prefill`` / ``model.decode_step``.

One module-scoped spawn (``parallel.ranks.run_ranks``: 4 ranks, a 60 s
group timeout) runs every case of :data:`CASES` in f32: a prefill of a
numpy-seeded prompt at ``max_seq`` 64, and decode steps on fixed numpy
tokens (teacher-forced) from the reference's one-device prefill cache of
that prompt, so that every side decodes the same inputs (a prefill cache
one bf16 ulp off moves the logits by ~1e-3), once with that cache in f32
and once in bf16, as served; each rank on its part of the params
(``param_specs``) and of the decode cache (``cache_specs``).  Cases:
qwen3-1.7b SMOKE on a (2, 2) and a (1, 2, 2) mesh and without sequence
parallelism; gemma3-12b SMOKE (window 16: a
12-token prompt decoded past slot 16, and a 48-token prompt whose ring
wrapped in prefill); qwen2-1.5b (qkv biases, 2 kv heads); nemotron-4-340b
(squared ReLU, 6 heads); a padded vocabulary (300 of 512 ids);
``impl="kernel"`` (on the CPU K3's plain version); serve at B 1 (the
long-context branch: the cache's sequence over "data", from the
reference's one-device prefill); and a (B,) position vector whose rows'
slots lie on different ranks.  The parent assembles the ranks' parts
with ``sharding.assemble`` (which also checks that the copies of a
replicated part are equal).  The weights are the reference's
``init_params`` (numpy) through ``interop.params_from_jax(train=True)``.

Tolerances (the reference's own sharded-vs-one-device differences are
3e-6 on logits and one bf16 ulp on the cache, its prefill rounding f32
K / V into a bf16 cache): logits 1e-4 absolute (prefill, and decode on
the f32 cache, against the reference and one device); decode on the
bf16 cache against one device :data:`BF16_DECODE_TOL` (each step writes
the new K / V rounded to bf16, and the f32 values, summed over the ranks
in another order, round to the neighbouring bf16 value now and then: one
such element moved the logits by up to 4e-4 in these cases, where an f32
cache keeps them within 3e-6), greedy tokens equal where one device's
top-2 margin exceeds that; cache leaves one bf16
ulp of the element plus 1e-6 of the leaf's largest |value| (|a - b| <=
2^-7 |b| + 1e-6 max |b|: the f32 K / V before the rounding, summed in
another order, differ on the scale of the leaf, which near zero is more
than an element's ulp); the next position and the greedy tokens equal.

The ranks import this file, so JAX is imported by the parent only,
inside :func:`_ref`.
"""
import dataclasses
import functools
import math
import types
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import model as M
from repro_torch.parallel import context
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks

torch.set_num_threads(2)
LOGIT_TOL = 1e-4
BF16_DECODE_TOL = 2e-3
CACHE_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
GROUP_TIMEOUT = 60.0
LIMIT = 240.0
MAX_SEQ = 64
QWEN, GEMMA = "qwen3-1.7b", "gemma3-12b"
MESHES = {"data_model": ((2, 2), ("data", "model")),
          "pod_data_model": ((1, 2, 2), ("pod", "data", "model"))}


class Case(NamedTuple):
    arch: str
    over: tuple = ()
    mesh: str = "data_model"
    kw: dict = {}               # make_prefill_step keywords
    prompt: int = 48
    batch: int = 4
    decodes: int = 3
    # per-step (B,) positions instead of the prefill's next position on
    positions: Optional[tuple] = None


# the rows' slots at 31 / 32 (the two "model" ranks' halves of 64), 40
# and 5
VECTOR = ((5, 31, 40, 32), (6, 32, 41, 33))
CASES = {
    "qwen3": Case(QWEN),
    "qwen3_pod": Case(QWEN, mesh="pod_data_model"),
    "qwen3_no_sp": Case(QWEN, kw={"seq_parallel": False}),
    "qwen3_kernel": Case(QWEN, kw={"impl": "kernel"}),
    "qwen3_pad": Case(QWEN, (("vocab_size", 300),)),
    "gemma3_short": Case(GEMMA, prompt=12, decodes=6),
    "gemma3_wrapped": Case(GEMMA),
    "qwen2": Case("qwen2-1.5b"),
    "nemotron": Case("nemotron-4-340b"),
    "qwen3_b1": Case(QWEN, batch=1),
    "qwen3_vector": Case(QWEN, decodes=2, positions=VECTOR),
}
# the cases held against the reference's jitted steps, and the case whose
# reference they share
REFERENCE = {"qwen3": "qwen3", "qwen3_pod": "qwen3", "qwen3_no_sp": "qwen3",
             "qwen3_kernel": "qwen3", "qwen3_pad": "qwen3_pad",
             "gemma3_short": "gemma3_short",
             "gemma3_wrapped": "gemma3_wrapped", "qwen2": "qwen2",
             "nemotron": "nemotron", "qwen3_b1": "qwen3_b1"}


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (JAX on the CPU; conftest's 4 devices)."""
    import jax
    from jax.sharding import NamedSharding
    from repro import configs as rconfigs
    from repro.launch import steps as rsteps
    from repro.launch.shapes import ShapeSpec as RShapeSpec
    from repro.models import model as RM

    def mesh(name):
        shape, names = MESHES[name]
        return jax.make_mesh(shape, names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(names))

    return types.SimpleNamespace(jax=jax, NamedSharding=NamedSharding,
                                 configs=rconfigs, steps=rsteps, RM=RM,
                                 mesh=mesh, ShapeSpec=RShapeSpec)


def _cfg(arch, overrides=(), ref=False):
    get = _ref().configs.get_smoke if ref else configs.get_smoke
    return dataclasses.replace(get(arch), policy="f32", **dict(overrides))


def _shape(case: Case) -> ShapeSpec:
    return ShapeSpec("serve", "decode", MAX_SEQ, case.batch)


@functools.lru_cache(maxsize=None)
def _weights(arch, overrides=()):
    """The reference's init_params (seed 0) as numpy."""
    r = _ref()
    return r.jax.device_get(r.jax.jit(r.RM.init_params, static_argnums=1)(
        r.jax.random.PRNGKey(0), _cfg(arch, overrides, ref=True)))


def _params(case: Case):
    return params_from_jax(_weights(case.arch, case.over),
                           _cfg(case.arch, case.over), device="cpu",
                           train=True)


def _tokens(case: Case):
    """(prompt (B, prompt), [decode tokens (B, 1)]) int32, numpy seed 0."""
    rng = np.random.default_rng(0)
    vocab = _cfg(case.arch, case.over).vocab_size
    prompt = rng.integers(0, vocab, (case.batch, case.prompt))
    steps_ = [rng.integers(0, vocab, (case.batch, 1))
              for _ in range(case.decodes)]
    return prompt.astype(np.int32), [t.astype(np.int32) for t in steps_]


def _mesh_shape(name):
    shape, names = MESHES[name]
    return S.MeshShape(names, shape)


def _to_torch(node):
    """A numpy / jax tree as torch tensors (bf16 kept)."""
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return tuple(_to_torch(v) for v in node)
    a = np.asarray(node)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


@functools.lru_cache(maxsize=None)
def _reference_prefill_cache(name):
    """The reference's one-device ``M.prefill`` cache of the case's
    prompt (the B 1 case's start), as torch, and its next position."""
    r = _ref()
    case = CASES[name]
    prompt, _ = _tokens(case)
    _, cache, st = r.jax.jit(functools.partial(
        r.RM.prefill, cfg=_cfg(case.arch, case.over, ref=True),
        max_seq=MAX_SEQ))(_weights(case.arch, case.over), prompt)
    return _to_torch(r.jax.device_get(cache)), int(st)


# ----------------------------------------------------------------- ranks ----

def _clone(t):
    return tree.map(lambda x: x.clone(), t)


def _rank_cases(rank, world, cases):
    """The ranks' side: every case's prefill and decode steps; the
    repaired ``final_logits``; the vocab-parallel argmax's ties; the
    call-time refusals."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {name: make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    out = {}
    for name, inp in cases.items():
        case = CASES[name]
        cfg, mesh = _cfg(case.arch, case.over), meshes[case.mesh]
        serve, (p_specs, c_specs, _, _), _ = steps.make_serve_step(
            cfg, _shape(case), mesh)
        local = S.local_tree(inp["params"], p_specs, mesh)
        res = {}
        if case.batch > 1:
            prefill, _, _ = steps.make_prefill_step(cfg, _shape(case), mesh,
                                                    **case.kw)
            res["prefill"] = prefill(local, inp["prompt"])
        res["decode"], res["cache"] = {}, {}
        for dt, dtype in CACHE_DTYPES.items():
            cache = S.local_tree(tree.map(lambda t: t.to(dtype),
                                          inp["cache"]), c_specs, mesh)
            res["parts"] = [tuple(t.shape) for t in tree.leaves(cache)]
            pos, res["decode"][dt] = inp["pos"], []
            for i, tok in enumerate(inp["decode"]):
                at = (np.asarray(case.positions[i]) if case.positions
                      else torch.tensor(pos) if i % 2 else pos)
                nxt, logits, cache = serve(local, cache, at, tok)
                res["decode"][dt].append((nxt, logits))
                pos += 1
            res["cache"][dt] = cache
        out[name] = res
    out["final_logits"] = _final_logits_case(meshes["data_model"])
    out["argmax_ties"] = _argmax_ties(meshes["data_model"])
    out["refused"] = _refusals(meshes["data_model"], cases["qwen3"])
    return out


def _final_logits_case(mesh):
    """``model.final_logits(last_only=True)`` under sequence parallelism
    on this rank's block of a (4, 8, 64) stream (numpy seed 5), against
    the one-device call on the whole stream (its rows and vocabulary
    slice): the prompt's last position is on the last "model" rank."""
    from repro_torch.launch.mesh import axes_group
    cfg = _cfg(QWEN)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(4, 8, cfg.d_model)).astype(
        np.float32))
    params = {"final_norm": {"scale": torch.from_numpy(rng.normal(
        size=cfg.d_model).astype(np.float32))},
        "unembed": torch.from_numpy(rng.normal(
            size=(cfg.d_model, cfg.padded_vocab)).astype(np.float32))}
    want = M.final_logits(params, x, cfg, last_only=True)
    _, n_tp, i_tp = axes_group(mesh, "model")
    _, n_dp, i_dp = axes_group(mesh, "data")
    rows = slice(i_dp * 2, i_dp * 2 + 2)
    cols = slice(i_tp * cfg.padded_vocab // n_tp,
                 (i_tp + 1) * cfg.padded_vocab // n_tp)
    part = {"final_norm": params["final_norm"],
            "unembed": params["unembed"][:, cols]}
    with context.activation_specs(act=S.P("data", "model", None),
                                  mesh=mesh):
        got = M.final_logits(part, x[rows, i_tp * 4:(i_tp + 1) * 4], cfg,
                             last_only=True)
    return got, want[rows][..., cols]


def _argmax_ties(mesh):
    """``collectives.vocab_argmax`` on a (3, 8) row set split over
    "model" (4 ids a rank): a tie across the ranks, a tie inside one
    rank, and the largest value past ``vocab_size`` (7 of 8 ids)."""
    from repro_torch.launch.mesh import axes_group
    from repro_torch.parallel import collectives as C
    logits = torch.tensor([[0., 5., 1., 2., 3., 5., 0., 0.],
                           [1., 1., 9., 9., 0., 0., 0., 0.],
                           [0., 0., 0., 1., 0., 2., 1., 9.]])
    _, _, i_tp = axes_group(mesh, "model")
    with context.activation_specs(act=S.P("data", None, None), mesh=mesh):
        return C.vocab_argmax(logits[:, i_tp * 4:(i_tp + 1) * 4], 7)


def _refusals(mesh, inp):
    """The steps' call-time refusals: a batch that does not divide over
    "data", a sequence that does not divide over "model" under sequence
    parallelism, frontend embeddings, a position past the cache, a cache
    part of another shape."""
    case = CASES["qwen3"]
    cfg = _cfg(QWEN)
    prefill, (p_specs, _, _), _ = steps.make_prefill_step(cfg, _shape(case),
                                                          mesh)
    serve, (_, c_specs, _, _), _ = steps.make_serve_step(cfg, _shape(case),
                                                         mesh)
    local = S.local_tree(inp["params"], p_specs, mesh)
    cache = S.local_tree(M.init_cache(cfg, 4, MAX_SEQ, device="cpu"),
                         c_specs, mesh)
    tok = inp["decode"][0]
    out = {}
    for what, fn in (
            ("batch", lambda: prefill(local, inp["prompt"][:3])),
            ("sequence", lambda: prefill(local, inp["prompt"][:, :47])),
            ("embeddings", lambda: prefill(local, inp["prompt"],
                                           np.zeros((4, 2, 64)))),
            ("overflow", lambda: serve(local, cache, MAX_SEQ, tok)),
            ("part", lambda: serve(local, tree.map(
                lambda t: t[:, :, :, :-1], cache), 3, tok))):
        try:
            fn()
        except ValueError as e:
            out[what] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of :func:`_rank_cases`."""
    cases = {}
    for name, case in CASES.items():
        prompt, decode = _tokens(case)
        cache, pos = _reference_prefill_cache(name)
        cases[name] = {"params": _params(case), "prompt": prompt,
                       "decode": decode, "cache": cache, "pos": pos}
    return run_ranks(_rank_cases, 4, cases, timeout=GROUP_TIMEOUT,
                     limit=LIMIT)


# ------------------------------------------------------------ both sides ----

def _specs(name):
    """(logits, cache, tokens) specs of the case's steps on its mesh."""
    case = CASES[name]
    mesh = _mesh_shape(case.mesh)
    _, (_, c_specs, _, tok_spec), _ = steps.make_serve_step(
        _cfg(case.arch, case.over), _shape(case), mesh)
    return S.P(tok_spec[0], None, "model"), c_specs, tok_spec, mesh


def _assembled(ranks, name, dt="f32"):
    """The case's prefill (logits, cache, S_total) and its decode steps'
    [(tokens, logits)] and final cache on the ``dt`` cache, assembled
    from the ranks' parts."""
    l_spec, c_specs, tok_spec, mesh = _specs(name)
    parts = [pr[name] for pr in ranks]
    out = {"decode": [
        (S.assemble([p["decode"][dt][i][0] for p in parts], tok_spec, mesh),
         S.assemble([p["decode"][dt][i][1] for p in parts], l_spec, mesh))
        for i in range(len(parts[0]["decode"][dt]))],
        "cache": S.assemble([p["cache"][dt] for p in parts], c_specs,
                            mesh)}
    if "prefill" in parts[0]:
        out["prefill"] = (
            S.assemble([p["prefill"][0] for p in parts], l_spec, mesh),
            S.assemble([p["prefill"][1] for p in parts], c_specs, mesh),
            [int(p["prefill"][2]) for p in parts])
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's ``jax.jit(make_prefill_step(...))`` on the case's
    prompt (not at B 1), and ``jax.jit(make_serve_step(...))`` on the
    decode tokens from its one-device prefill cache in f32: prefill
    (logits, cache, next position) and the steps' (tokens, logits) and
    final cache, numpy."""
    r = _ref()
    case = CASES[name]
    rcfg = _cfg(case.arch, case.over, ref=True)
    mesh = r.mesh(case.mesh)
    rshape = r.ShapeSpec(*dataclasses.astuple(_shape(case)))
    P = r.jax.sharding.PartitionSpec
    leaf = lambda x: isinstance(x, P) or x is None  # noqa: E731

    def put(x, spec):
        return r.jax.device_put(x, r.NamedSharding(mesh, spec))

    prompt, decode = _tokens(case)
    serve, (p_specs, c_specs, _, tok_spec), _ = r.steps.make_serve_step(
        rcfg, rshape, mesh)
    params = r.jax.tree.map(lambda s, x: put(x, s), p_specs,
                            _weights(case.arch, case.over), is_leaf=leaf)
    out = {}
    if case.batch > 1:
        prefill, (_, tok_in, _), _ = r.steps.make_prefill_step(
            rcfg, rshape, mesh)
        logits, cache, st = r.jax.jit(prefill)(params, put(prompt, tok_in))
        out["prefill"] = (np.asarray(logits), r.jax.device_get(cache),
                          int(st))
    cache, pos = _reference_prefill_cache(name)
    cache = r.jax.tree.map(lambda s, x: put(np.asarray(x.float()), s),
                           c_specs, cache, is_leaf=leaf)
    step = r.jax.jit(serve)
    out["decode"] = []
    for tok in decode:
        nxt, logits, cache = step(params, cache, np.int32(pos),
                                  put(tok, tok_spec))
        out["decode"].append((np.asarray(nxt), np.asarray(logits)))
        pos += 1
    out["cache"] = r.jax.device_get(cache)
    return out


@functools.lru_cache(maxsize=None)
def _one_device(name, dt="f32"):
    """The port's one-device ``M.prefill`` (not at B 1) and
    ``M.decode_step`` from the reference's prefill cache in ``dt``, on
    the same tokens and positions."""
    case = CASES[name]
    cfg = _cfg(case.arch, case.over)
    params = _params(case)
    prompt, decode = _tokens(case)
    out = {}
    if case.batch > 1:
        out["prefill"] = M.prefill(params, torch.from_numpy(prompt), cfg,
                                   max_seq=MAX_SEQ,
                                   impl=case.kw.get("impl", "chunked"))
    cache, pos = _reference_prefill_cache(name)
    cache = tree.map(lambda t: t.to(CACHE_DTYPES[dt]), _clone(cache))
    out["decode"] = []
    for i, tok in enumerate(decode):
        at = np.asarray(case.positions[i]) if case.positions else pos
        logits, cache = M.decode_step(params, cfg, cache, at,
                                      torch.from_numpy(tok))
        out["decode"].append(logits)
        pos += 1
    out["cache"] = cache
    return out


def _np(t) -> np.ndarray:
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t, dtype=np.float32))


def _logits_close(got, want, what):
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= LOGIT_TOL, (what, err)


def _cache_close(got, want, what, atol=None):
    """Every leaf (torch or numpy trees) within one bf16 ulp of the element
    plus ``atol``, by default 1e-6 of the leaf's largest |value|: |a - b|
    <= 2^-7 |b| + 1e-6 max |b|."""
    g, w = tree.leaves(got), tree.leaves(want)
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, (what, a.shape, b.shape)
        atol = 1e-6 * float(np.abs(b).max()) if atol is None else atol
        assert (np.abs(a - b) <= 2.0 ** -7 * np.abs(b) + atol).all(), (
            what, float(np.abs(a - b).max()))


# ----------------------------------------------------------------- tests ----

PREFILLED = sorted(n for n, c in CASES.items() if c.batch > 1
                   and n in REFERENCE)


@pytest.mark.parametrize("name", PREFILLED)
def test_prefill_matches_the_reference(ranks, name):
    """The assembled prefill logits within 1e-4 of the reference's jitted
    sharded prefill, the cache within one bf16 ulp, the next position
    equal on every rank."""
    got, want = _assembled(ranks, name)["prefill"], \
        _reference(REFERENCE[name])["prefill"]
    _logits_close(got[0], want[0], name)
    _cache_close(got[1], want[1], name)
    assert got[2] == [want[2]] * 4


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_decode_matches_the_reference(ranks, name):
    """On the f32 cache: every decode step's logits within 1e-4 of the
    reference's jitted sharded serve step, its greedy tokens equal, the
    final cache within one bf16 ulp."""
    got, want = _assembled(ranks, name), _reference(REFERENCE[name])
    for i, ((tok, lg), (rtok, rlg)) in enumerate(zip(got["decode"],
                                                    want["decode"])):
        _logits_close(lg, rlg, (name, i))
        assert np.array_equal(tok.numpy(), rtok), (name, i)
    _cache_close(got["cache"], want["cache"], name)


@pytest.mark.parametrize("dt", sorted(CACHE_DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_one_device(ranks, name, dt):
    """The assembled prefill logits within 1e-4 of the port's one-device
    ``M.prefill``, its cache within one bf16 ulp; the decode steps on the
    ``dt`` cache against ``M.decode_step`` from the same cache: logits
    within 1e-4 (f32) or :data:`BF16_DECODE_TOL` (bf16), the greedy
    tokens its argmax over the unpadded ids wherever its top-2 margin
    exceeds that, the final caches within one bf16 ulp (plus, on the
    bf16 cache, :data:`BF16_DECODE_TOL` absolute: the keys and values the
    steps write come from hidden states that differ as the logits do)."""
    got, want = _assembled(ranks, name, dt), _one_device(name, dt)
    vocab = _cfg(CASES[name].arch, CASES[name].over).vocab_size
    tol = LOGIT_TOL if dt == "f32" else BF16_DECODE_TOL
    if "prefill" in want and dt == "f32":
        _logits_close(got["prefill"][0], want["prefill"][0], name)
        _cache_close(got["prefill"][1], want["prefill"][1], name)
    for i, ((tok, lg), w) in enumerate(zip(got["decode"], want["decode"])):
        err = float((lg - w).abs().max())
        assert err <= tol, (name, dt, i, err)
        top2 = w[:, -1, :vocab].topk(2).values
        clear = top2[:, 0] - top2[:, 1] > tol
        assert torch.equal(tok[:, 0].long()[clear],
                           w[:, -1, :vocab].argmax(-1)[clear]), (name, i)
    _cache_close(got["cache"], want["cache"], name,
                 atol=None if dt == "f32" else BF16_DECODE_TOL)


def test_vector_positions_write_on_each_ranks_part(ranks):
    """The (B,) position vectors write slots on both halves of the
    cache's sequence (the two "model" ranks' parts of 32 slots): each
    row's new keys and values, at its own slot, replace the prefill's
    (the assembled caches before and after differ there and nowhere
    else), within one bf16 ulp of one device's."""
    assert {p // (MAX_SEQ // 2) for ps in VECTOR for p in ps} == {0, 1}
    got = _assembled(ranks, "qwen3_vector", "bf16")
    want = _one_device("qwen3_vector", "bf16")
    before = _reference_prefill_cache("qwen3_vector")[0]["slots"][0]["attn"]
    after = got["cache"]["slots"][0]["attn"]
    written = torch.zeros(after["k"].shape[1:4:2], dtype=torch.bool)
    for ps in VECTOR:
        written[torch.arange(len(ps)), torch.tensor(ps)] = True
    for name in ("k", "v"):
        moved = (after[name] != before[name]).any(-1).any(2).any(0)
        assert torch.equal(moved, written), name
        _cache_close(after[name], want["cache"]["slots"][0]["attn"][name],
                     name, atol=BF16_DECODE_TOL)


def test_final_logits_takes_the_last_ranks_position(ranks):
    """``final_logits(last_only=True)`` under sequence parallelism: every
    rank's logits are its rows and vocabulary slice of the prompt's last
    position (held by the last "model" rank), equal to one device's."""
    for pr in ranks:
        got, want = pr["final_logits"]
        assert got.shape == want.shape == (2, 1, 128)
        assert torch.allclose(got, want, rtol=1e-6, atol=1e-5)


def test_vocab_argmax_breaks_ties_to_the_lowest_id(ranks):
    """A tie across ranks (ids 1 and 5) gives 1, a tie inside a rank (2
    and 3) gives 2, and the largest value at a padded id (7 of 7) is
    excluded: 5; the same on every rank."""
    for pr in ranks:
        assert pr["argmax_ties"].tolist() == [1, 2, 5]


def test_each_rank_holds_its_part(ranks):
    """Each rank's cache leaves are exactly its ``local_index`` part under
    ``cache_specs`` (the sequence split, never the whole cache), on both
    branches: the batch over "data" and the sequence over "model" (B 4),
    the sequence over "data" (B 1)."""
    for name in ("qwen3", "qwen3_pod", "gemma3_wrapped", "qwen3_b1"):
        case = CASES[name]
        _, c_specs, _, mesh = _specs(name)
        whole = tree.leaves(steps.abstract_cache(_cfg(case.arch, case.over),
                                                 _shape(case)))
        flat = _spec_leaves(c_specs)
        for r, pr in enumerate(ranks):
            assert len(pr[name]["parts"]) == len(whole) == len(flat)
            for spec, g, got in zip(flat, whole, pr[name]["parts"]):
                idx = S.local_index(S.P(*spec), g.shape, mesh,
                                    S.rank_coords(mesh, r))
                want = tuple(len(range(*i.indices(n)))
                             for i, n in zip(idx, g.shape))
                assert got == want, (name, r)
                assert math.prod(got) < g.numel()


@pytest.mark.parametrize("what,match", [
    ("batch", r"the batch 3 does not divide over the 2 ranks of 'data'"),
    ("sequence", r"the sequence 47 does not divide over the 2 ranks of "
                 r"'model'"),
    ("embeddings", r"frontend embeddings.*item 4b\.5"),
    ("overflow", r"write position 64 >= cache capacity 64"),
    ("part", r"cache leaf slots/0/attn/k is \(2, 2, 2, 31, 16\)")])
def test_the_steps_refuse_inputs_they_cannot_split(ranks, what, match):
    import re
    for pr in ranks:
        assert re.search(match, pr["refused"][what]), pr["refused"][what]


# ---------------------------------------------------- no ranks needed ----

@pytest.mark.parametrize("arch", [QWEN, GEMMA, "nemotron-4-340b",
                                  "llama4-scout-17b-a16e", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_abstract_cache_matches_the_reference(arch):
    """Full size at the reference's decode_32k shape: ``abstract_cache``
    (on ``meta``) == the reference's ``jax.eval_shape`` leaf for leaf,
    shapes and dtypes."""
    r = _ref()
    shape = ShapeSpec("decode_32k", "decode", 32768, 128)
    got = tree.leaves(steps.abstract_cache(configs.get_config(arch), shape))
    want = r.jax.tree.leaves(r.steps.abstract_cache(
        r.configs.get_config(arch),
        r.ShapeSpec(*dataclasses.astuple(shape))))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``jax.tree.leaves`` order (a ``None``
    entry is no leaf there)."""
    def walk(node):
        if node is None:
            return []
        if isinstance(node, S.PartitionSpec):
            return [tuple(node)]
        if isinstance(node, dict):
            return [x for k in sorted(node) for x in walk(node[k])]
        return [x for v in node for x in walk(v)]
    return walk(specs)


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("factory", ["make_prefill_step", "make_serve_step"])
def test_specs_match_the_reference(factory, mesh_name, batch):
    """Each factory's spec triple == the reference's, entry for entry
    (``None`` where the reference's has ``None``), at a batch that fills
    the data axes and at B 1 (the long-context cache specs)."""
    r = _ref()
    shape = ShapeSpec("serve", "decode", MAX_SEQ, batch)
    _, ins, outs = getattr(steps, factory)(_cfg(GEMMA), shape,
                                           _mesh_shape(mesh_name))
    _, rins, routs = getattr(r.steps, factory)(
        _cfg(GEMMA, ref=True), r.ShapeSpec(*dataclasses.astuple(shape)),
        r.mesh(mesh_name))
    P = r.jax.sharding.PartitionSpec
    want = [tuple(s) for s in r.jax.tree.leaves(
        (rins, routs), is_leaf=lambda x: isinstance(x, P))]
    assert _spec_leaves((ins, outs)) == want
    if factory == "make_serve_step":
        assert outs[1] is None and routs[1] is None


REFUSALS = {
    "moe": ("llama4-scout-17b-a16e", (("n_experts", 3),),
            r"n_experts 3 does not divide over the 2 ranks of 'model'"),
    "rwkv": ("rwkv6-7b", (), r"\['rwkv'\] layers.*item 4b\.4"),
    "mamba": ("zamba2-1.2b", (), r"\['mamba'\] layers.*item 4b\.4"),
    "frontend": ("musicgen-large", (),
                 r"frontend 'audio' embeddings.*item 4b\.5"),
    "shared_attn": (QWEN, (("shared_attn_every", 1),),
                    r"shared attention block.*item 4b\.6"),
    "tied": (QWEN, (("tie_embeddings", True),), r"tied embeddings.*item "
                                                r"4b\.7"),
    "heads": (QWEN, (("n_heads", 3), ("n_kv_heads", 1)),
              r"n_heads 3 does not divide over the 2 ranks"),
    "kv_heads": (QWEN, (("n_kv_heads", 1), ("n_heads", 2)),
                 r"n_kv_heads 1 does not divide over the 2 ranks"),
    "max_seq": (QWEN, (), r"decode cache's slots/0/attn/k: dim 3 of "
                          r"\(2, 4, 2, 63, 16\) does not divide over the 2 "
                          r"ranks of 'model'"),
    "window": (GEMMA, (("local_window", 15),),
               r"decode cache's slots/0/attn/k: dim 3 of \(2, 4, 2, 15, "
               r"16\) does not divide"),
}


@pytest.mark.parametrize("factory", ["make_prefill_step", "make_serve_step"])
@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_a_mesh_refuses(what, factory):
    """Each refusal names the factory and the ROADMAP item or the
    sizes."""
    arch, over, match = REFUSALS[what]
    seq = 63 if what == "max_seq" else MAX_SEQ
    with pytest.raises(ValueError, match=f"{factory}: .*{match}"):
        getattr(steps, factory)(_cfg(arch, over),
                                ShapeSpec("serve", "decode", seq, 4),
                                _mesh_shape("data_model"))
