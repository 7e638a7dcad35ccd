"""The serving steps on a mesh with the pjit MoE (``launch.steps.
make_prefill_step`` / ``make_serve_step`` on llama4-scout and
llama4-maverick, ``models.moe.apply_moe`` under the MoE hints) on gloo
ranks on the CPU, vs the reference's jitted sharded steps and vs the
port's one-device ``model.prefill`` / ``model.decode_step``.

One module-scoped spawn (``parallel.ranks.run_ranks``: 4 ranks, a 60 s
group timeout) runs every case of :data:`CASES` in f32, as
``test_torch_serve_mesh.py`` runs the dense ones: a prefill of a
numpy-seeded 48-token prompt at ``max_seq`` 64, and decode steps on fixed
numpy tokens from the reference's one-device prefill cache of that prompt
(in f32 and in bf16), so that every side decodes the same inputs; each
rank on its part of the params (``param_specs``: E / tp experts, their d
or ``d_ff`` split over the data axes) and of the decode cache
(``cache_specs``: the ``moe`` occupancy replicated).  Cases: scout SMOKE
on a (2, 2) and a (1, 2, 2) mesh and without sequence parallelism;
``capacity_factor`` 1.0 (tokens dropped in prefill and in decode);
maverick SMOKE (``attn`` and ``attn+moe`` layers); bcsr dispatch, held
``torch.equal`` to the gather case rank by rank and against the
reference's gather (the reference's bcsr does not run under a mesh: its
sharded engine builds a mesh of its own); serve at B 1 (the long-context
branch, from the reference's one-device prefill; the reference's groups
warning); a (B,) position vector; a ``moe_impl="shard_map"`` prefill
(the reference's warning and its zero counts).  The layer itself: one
rank's dispatch buffer ``torch.equal`` to its slice of one device's, its
expert product on E / tp experts.

Tolerances: logits 1e-4 absolute (prefill, and decode on the f32 cache);
decode on the bf16 cache against one device ``BF16_DECODE_TOL`` (2e-3, as
the dense test states it), greedy tokens equal where one device's top-2
margin exceeds that; caches one bf16 ulp plus 1e-6 of the leaf's largest;
the MoE counts (after prefill and after every step), the next position and
the greedy tokens equal.

The ranks import this file, so JAX is imported by the parent only, inside
``_ref``.
"""
import dataclasses
import functools
import math
import re
import warnings
from typing import NamedTuple, Optional

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.parallel import context
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks
from test_torch_serve_mesh import (BF16_DECODE_TOL, CACHE_DTYPES, LOGIT_TOL,
                                   MESHES, _cache_close, _mesh_shape, _np,
                                   _ref, _spec_leaves, _to_torch)

GROUP_TIMEOUT = 60.0
LIMIT = 240.0
MAX_SEQ = 64
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
SHARD_MAP_WARNING = ("make_prefill_step(moe_impl='shard_map'): the shard_map "
                     "MoE impl is train-only")
GROUPS_WARNING = (r"apply_moe: 2 dispatch group\(s\) requested but the "
                  r"batch dim B=1 is not divisible")


class Case(NamedTuple):
    arch: str
    over: tuple = ()
    mesh: str = "data_model"
    kw: dict = {}               # make_prefill_step keywords
    dispatch: str = "gather"
    batch: int = 4
    decodes: int = 3
    # per-step (B,) positions instead of the prefill's next position on
    positions: Optional[tuple] = None


# the rows' slots on both "model" ranks' halves of the 64
VECTOR = ((5, 31, 40, 32), (6, 32, 41, 33))
CASES = {
    "scout": Case(SCOUT),
    "scout_pod": Case(SCOUT, mesh="pod_data_model"),
    "scout_no_sp": Case(SCOUT, kw={"seq_parallel": False}),
    "scout_drop": Case(SCOUT, (("capacity_factor", 1.0),)),
    "scout_bcsr": Case(SCOUT, dispatch="bcsr"),
    "maverick": Case(MAVERICK),
    "scout_b1": Case(SCOUT, batch=1),
    "scout_vector": Case(SCOUT, decodes=2, positions=VECTOR),
    "scout_shard_map": Case(SCOUT, kw={"moe_impl": "shard_map"}, decodes=0),
}
# the cases held against the reference's jitted steps, and the case whose
# reference they share (its gather dispatch, the pjit impl)
REFERENCE = {"scout": "scout", "scout_pod": "scout", "scout_no_sp": "scout",
             "scout_drop": "scout_drop", "scout_bcsr": "scout",
             "maverick": "maverick", "scout_b1": "scout_b1",
             "scout_shard_map": "scout_shard_map"}


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
    """(prompt (B, 48), [decode tokens (B, 1)]) int32, numpy seed 0."""
    rng = np.random.default_rng(0)
    vocab = _cfg(case.arch, case.over).vocab_size
    prompt = rng.integers(0, vocab, (case.batch, 48))
    steps_ = [rng.integers(0, vocab, (case.batch, 1))
              for _ in range(case.decodes)]
    return prompt.astype(np.int32), [t.astype(np.int32) for t in steps_]


def _cache_in(cache, dtype):
    """A copy of a prefill cache, its floating leaves in ``dtype`` (K /
    V), the MoE counts int32 as they are."""
    return tree.map(lambda t: t.to(dtype if t.is_floating_point()
                                   else t.dtype, copy=True), cache)


def _counts(cache) -> list:
    """The ``moe`` leaf of every attn+moe slot, copied."""
    return [slot["moe"].clone() for slot in cache["slots"] if "moe" in slot]


@functools.lru_cache(maxsize=None)
def _reference_prefill_cache(name):
    """The reference's one-device ``M.prefill`` cache of the case's
    prompt, as torch, and its next position."""
    r = _ref()
    case = CASES[name]
    prompt, _ = _tokens(case)
    _, cache, st = r.jax.jit(functools.partial(
        r.RM.prefill, cfg=_cfg(case.arch, case.over, ref=True),
        max_seq=MAX_SEQ))(_weights(case.arch, case.over), prompt)
    return _to_torch(r.jax.device_get(cache)), int(st)


# ----------------------------------------------------------------- ranks ----

def _rank_cases(rank, world, cases, layer):
    """The ranks' side: every case's prefill and decode steps (the MoE
    counts after each), the warnings each case gave, its parts' shapes;
    the layer's dispatch on this rank."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {name: make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    out = {}
    for name, inp in cases.items():
        case = CASES[name]
        cfg, mesh = _cfg(case.arch, case.over), meshes[case.mesh]
        res = {"decode": {}, "counts": {}, "cache": {}}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            serve, (p_specs, c_specs, _, _), _ = steps.make_serve_step(
                cfg, _shape(case), mesh, moe_dispatch=case.dispatch)
            local = S.local_tree(inp["params"], p_specs, mesh)
            res["experts"] = [tuple(t.shape) for t in tree.leaves(
                [slot["ffn"]["experts"] for slot in local["blocks"]
                 if "experts" in slot["ffn"]])]
            if case.batch > 1:
                prefill, _, _ = steps.make_prefill_step(
                    cfg, _shape(case), mesh, moe_dispatch=case.dispatch,
                    **case.kw)
                res["prefill"] = prefill(local, inp["prompt"])
            for dt, dtype in CACHE_DTYPES.items():
                if not case.decodes:
                    break
                cache = S.local_tree(_cache_in(inp["cache"], dtype), c_specs,
                                     mesh)
                res["parts"] = [tuple(t.shape) for t in tree.leaves(cache)]
                pos, res["decode"][dt], res["counts"][dt] = inp["pos"], [], []
                for i, tok in enumerate(inp["decode"]):
                    at = (np.asarray(case.positions[i]) if case.positions
                          else torch.tensor(pos) if i % 2 else pos)
                    nxt, logits, cache = serve(local, cache, at, tok)
                    res["decode"][dt].append((nxt, logits))
                    res["counts"][dt].append(_counts(cache))
                    pos += 1
                res["cache"][dt] = cache
        res["warnings"] = [str(w.message) for w in caught]
        out[name] = res
    out["layer"] = {d: _layer_case(meshes["data_model"], layer, d)
                    for d in ("gather", "bcsr")}
    return out


def _layer_case(mesh, inp, dispatch):
    """``moe.apply_moe`` under the prefill's hints on this rank's block
    of a (4, 48, 64) stream (numpy seed 3; rows over "data", positions
    over "model"), its params the first layer's as ``layer_gather`` gives
    them: the dispatch buffer the expert product saw (``_expert_ffn``
    wrapped), the experts it had, the output and the new counts."""
    cfg = _cfg(SCOUT)
    seen = []
    ffn = moe._expert_ffn

    def spy(experts, xe, mlp_type):
        seen.append((xe.clone(), tuple(experts["w_gate"].shape)))
        return ffn(experts, xe, mlp_type)

    p_specs = S.param_specs(steps.abstract_params(cfg), mesh)
    local = S.local_tree(inp["params"], p_specs, mesh)
    coords = S.my_coords(mesh)
    rows = slice(2 * coords["data"], 2 * coords["data"] + 2)
    cols = slice(24 * coords["model"], 24 * coords["model"] + 24)
    moe._expert_ffn = spy
    try:
        with torch.no_grad(), context.activation_specs(
                act=S.P("data", "model", None),
                moe=S.P("model", "data", None, None),
                moe_combine=S.P("data", None, None), moe_groups=2,
                mesh=mesh):
            p = steps.layer_gather(p_specs, mesh, torch.float32, True)(
                0, M._take(local["blocks"][0], 0))["ffn"]
            out, counts = moe.apply_moe(p, inp["x"][rows, cols], cfg,
                                        dispatch=dispatch, full_grid=True)
    finally:
        moe._expert_ffn = ffn
    (xe, experts), = seen
    return {"xe": xe, "experts": experts, "out": out, "counts": counts}


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of :func:`_rank_cases`."""
    cases = {}
    for name, case in CASES.items():
        prompt, decode = _tokens(case)
        cache, pos = _reference_prefill_cache(name)
        cases[name] = {"params": _params(case), "prompt": prompt,
                       "decode": decode, "cache": cache, "pos": pos}
    layer = {"params": cases["scout"]["params"], "x": _layer_x()}
    return run_ranks(_rank_cases, 4, cases, layer, timeout=GROUP_TIMEOUT,
                     limit=LIMIT)


def _layer_x() -> torch.Tensor:
    cfg = _cfg(SCOUT)
    return torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 48, cfg.d_model)).astype(np.float32))


# ------------------------------------------------------------ both sides ----

def _specs(name):
    """(logits, cache, tokens) specs of the case's steps on its mesh."""
    case = CASES[name]
    mesh = _mesh_shape(case.mesh)
    _, (_, c_specs, _, tok_spec), _ = steps.make_serve_step(
        _cfg(case.arch, case.over), _shape(case), mesh)
    return S.P(tok_spec[0], None, "model"), c_specs, tok_spec, mesh


def _replicated(parts: list) -> list:
    """Rank 0's copy of a replicated list of tensors, after checking that
    every rank holds the same."""
    for p in parts[1:]:
        assert all(torch.equal(a, b) for a, b in zip(p, parts[0]))
    return parts[0]


def _assembled(ranks, name, dt="f32"):
    """The case's prefill (logits, cache, S_total) and its decode steps'
    [(tokens, logits)], counts after each step and final cache on the
    ``dt`` cache, assembled from the ranks' parts."""
    l_spec, c_specs, tok_spec, mesh = _specs(name)
    parts = [pr[name] for pr in ranks]
    out = {"decode": [], "counts": []}
    if dt in parts[0]["decode"]:
        out["decode"] = [
            (S.assemble([p["decode"][dt][i][0] for p in parts], tok_spec,
                        mesh),
             S.assemble([p["decode"][dt][i][1] for p in parts], l_spec,
                        mesh))
            for i in range(len(parts[0]["decode"][dt]))]
        out["counts"] = [_replicated([p["counts"][dt][i] for p in parts])
                         for i in range(len(out["decode"]))]
        out["cache"] = S.assemble([p["cache"][dt] for p in parts], c_specs,
                                  mesh)
    if "prefill" in parts[0]:
        out["prefill"] = (
            S.assemble([p["prefill"][0] for p in parts], l_spec, mesh),
            S.assemble([p["prefill"][1] for p in parts], c_specs, mesh),
            [int(p["prefill"][2]) for p in parts])
    return out


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's ``jax.jit(make_prefill_step(...))`` (gather
    dispatch, the case's ``moe_impl``) on the case's prompt (not at B 1),
    and ``jax.jit(make_serve_step(...))`` on the decode tokens from its
    one-device prefill cache in f32: prefill (logits, cache, next
    position), the steps' (tokens, logits), the counts after each step,
    the final cache (numpy) and the warnings."""
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
    out = {"decode": [], "counts": []}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        serve, (p_specs, c_specs, _, tok_spec), _ = r.steps.make_serve_step(
            rcfg, rshape, mesh)
        params = r.jax.tree.map(lambda s, x: put(x, s), p_specs,
                                _weights(case.arch, case.over), is_leaf=leaf)
        if case.batch > 1:
            kw = {k: v for k, v in case.kw.items() if k == "moe_impl"}
            prefill, (_, tok_in, _), _ = r.steps.make_prefill_step(
                rcfg, rshape, mesh, **kw)
            logits, cache, st = r.jax.jit(prefill)(params,
                                                   put(prompt, tok_in))
            out["prefill"] = (np.asarray(logits), r.jax.device_get(cache),
                              int(st))
        cache, pos = _reference_prefill_cache(name)
        cache = r.jax.tree.map(lambda s, x: put(x.numpy(), s), c_specs,
                               _cache_in(cache, torch.float32), is_leaf=leaf)
        step = r.jax.jit(serve)
        for tok in decode:
            nxt, logits, cache = step(params, cache, np.int32(pos),
                                      put(tok, tok_spec))
            out["decode"].append((np.asarray(nxt), np.asarray(logits)))
            out["counts"].append(_counts(_to_torch(r.jax.device_get(cache))))
            pos += 1
        out["cache"] = r.jax.device_get(cache)
    out["warnings"] = [str(w.message) for w in caught]
    return out


@functools.lru_cache(maxsize=None)
def _one_device(name, dt="f32"):
    """The port's one-device ``M.prefill`` (not at B 1) and
    ``M.decode_step`` from the reference's prefill cache in ``dt``, on
    the same tokens and positions (the case's dispatch)."""
    case = CASES[name]
    cfg = _cfg(case.arch, case.over)
    params = _params(case)
    prompt, decode = _tokens(case)
    out = {"decode": [], "counts": []}
    if case.batch > 1:
        out["prefill"] = M.prefill(params, torch.from_numpy(prompt), cfg,
                                   max_seq=MAX_SEQ, dispatch=case.dispatch)
    cache, pos = _reference_prefill_cache(name)
    cache = _cache_in(cache, CACHE_DTYPES[dt])
    for i, tok in enumerate(decode):
        at = np.asarray(case.positions[i]) if case.positions else pos
        logits, cache = M.decode_step(params, cfg, cache, at,
                                      torch.from_numpy(tok),
                                      dispatch=case.dispatch)
        out["decode"].append(logits)
        out["counts"].append(_counts(cache))
        pos += 1
    out["cache"] = cache
    return out


def _logits_close(got, want, what):
    err = float(np.abs(_np(got) - _np(want)).max())
    assert err <= LOGIT_TOL, (what, err)


def _counts_equal(got, want, what):
    assert len(got) == len(want) > 0, what
    for a, b in zip(got, want):
        assert torch.equal(a, torch.as_tensor(np.asarray(b))), what


# ----------------------------------------------------------------- tests ----

PREFILLED = sorted(n for n in REFERENCE if CASES[n].batch > 1)
DECODED = sorted(n for n, c in CASES.items() if c.decodes)


@pytest.mark.parametrize("name", PREFILLED)
def test_prefill_matches_the_reference(ranks, name):
    """The assembled prefill logits within 1e-4 of the reference's jitted
    sharded prefill, the cache within one bf16 ulp, its MoE counts equal
    (zeros under ``moe_impl="shard_map"``, as the reference's), the next
    position equal on every rank."""
    got = _assembled(ranks, name)["prefill"]
    want = _reference(REFERENCE[name])["prefill"]
    _logits_close(got[0], want[0], name)
    _cache_close(got[1], want[1], name)
    _counts_equal(_counts(got[1]), _counts(_to_torch(want[1])), name)
    assert got[2] == [want[2]] * 4
    if name == "scout_shard_map":
        assert not any(c.any() for c in _counts(got[1]))
    else:
        assert all(c.sum() > 0 for c in _counts(got[1]))


@pytest.mark.parametrize("name", sorted(n for n in REFERENCE
                                        if CASES[n].decodes))
def test_decode_matches_the_reference(ranks, name):
    """On the f32 cache: every decode step's logits within 1e-4 of the
    reference's jitted sharded serve step, its greedy tokens and MoE
    counts equal, the final cache within one bf16 ulp."""
    got, want = _assembled(ranks, name), _reference(REFERENCE[name])
    for i, ((tok, lg), (rtok, rlg)) in enumerate(zip(got["decode"],
                                                    want["decode"])):
        _logits_close(lg, rlg, (name, i))
        assert np.array_equal(tok.numpy(), rtok), (name, i)
        _counts_equal(got["counts"][i], want["counts"][i], (name, i))
    _cache_close(got["cache"], want["cache"], name)


@pytest.mark.parametrize("dt", sorted(CACHE_DTYPES))
@pytest.mark.parametrize("name", DECODED)
def test_matches_one_device(ranks, name, dt):
    """The assembled prefill against the port's one-device ``M.prefill``
    (logits within 1e-4, cache within one bf16 ulp, counts equal); the
    decode steps on the ``dt`` cache against ``M.decode_step`` from the
    same cache: logits within 1e-4 (f32) or ``BF16_DECODE_TOL`` (bf16),
    the counts after every step equal, the greedy tokens its argmax over
    the ids wherever its top-2 margin exceeds that, the final caches
    within one bf16 ulp (plus, on the bf16 cache, ``BF16_DECODE_TOL``)."""
    got, want = _assembled(ranks, name, dt), _one_device(name, dt)
    vocab = _cfg(CASES[name].arch, CASES[name].over).vocab_size
    tol = LOGIT_TOL if dt == "f32" else BF16_DECODE_TOL
    if "prefill" in want and dt == "f32":
        _logits_close(got["prefill"][0], want["prefill"][0], name)
        _cache_close(got["prefill"][1], want["prefill"][1], name)
        _counts_equal(_counts(got["prefill"][1]),
                      _counts(want["prefill"][1]), name)
    for i, ((tok, lg), w) in enumerate(zip(got["decode"], want["decode"])):
        err = float((lg - w).abs().max())
        assert err <= tol, (name, dt, i, err)
        _counts_equal(got["counts"][i], want["counts"][i], (name, dt, i))
        top2 = w[:, -1, :vocab].topk(2).values
        clear = top2[:, 0] - top2[:, 1] > tol
        assert torch.equal(tok[:, 0].long()[clear],
                           w[:, -1, :vocab].argmax(-1)[clear]), (name, i)
    _cache_close(got["cache"], want["cache"], name,
                 atol=None if dt == "f32" else BF16_DECODE_TOL)


def test_capacity_one_drops_tokens():
    """The ``capacity_factor`` 1.0 case drops tokens in prefill and in
    decode (one device's routing on the reference's counts): a
    row-expert's count past its prefix capacity."""
    case = CASES["scout_drop"]
    cfg = _cfg(case.arch, case.over)
    start, pos = _reference_prefill_cache("scout_drop")
    cap = moe.prefix_capacity(torch.tensor(pos - 1), cfg.n_experts,
                              cfg.capacity_factor)
    assert any((c > cap).any() for c in _counts(start))
    want = _one_device("scout_drop")["counts"][-1]
    last = moe.prefix_capacity(torch.tensor(pos + case.decodes - 1),
                               cfg.n_experts, cfg.capacity_factor)
    assert any((c > last).any() for c in want)


@pytest.mark.parametrize("dt", sorted(CACHE_DTYPES))
def test_bcsr_equals_gather_rank_by_rank(ranks, dt):
    """Each rank's prefill logits, cache and S_total, decode tokens,
    logits, counts and final cache under bcsr dispatch ``torch.equal`` to
    the gather case's (the same inputs)."""
    for pr in ranks:
        a, b = pr["scout_bcsr"], pr["scout"]
        for x, y in zip(tree.leaves(a["prefill"][:2]),
                        tree.leaves(b["prefill"][:2])):
            assert torch.equal(x, y)
        assert int(a["prefill"][2]) == int(b["prefill"][2])
        for x, y in zip(tree.leaves((a["decode"][dt], a["counts"][dt],
                                     a["cache"][dt])),
                        tree.leaves((b["decode"][dt], b["counts"][dt],
                                     b["cache"][dt]))):
            assert torch.equal(x, y)


@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
def test_a_ranks_dispatch_is_its_slice_of_one_devices(ranks, dispatch):
    """The layer on a rank's rows and positions: the expert product sees
    E / tp = 2 of 4 experts, each gathered whole over "data" (d 64, ff
    96); its dispatch buffer ``torch.equal`` to the same slice (its
    experts, its rows) of one device's (E, B, C, d) buffer; the output
    within 1e-5 of one device's block, the new counts its rows'."""
    cfg = _cfg(SCOUT)
    params = M._take(_params(CASES["scout"])["blocks"][0], 0)["ffn"]
    x = _layer_x()
    seen = []
    ffn = moe._expert_ffn

    def spy(experts, xe, mlp_type):
        seen.append(xe.clone())
        return ffn(experts, xe, mlp_type)

    moe._expert_ffn = spy
    try:
        want, counts = moe.apply_moe(params, x, cfg, dispatch=dispatch,
                                     full_grid=True)
    finally:
        moe._expert_ffn = ffn
    E, cap = cfg.n_experts, moe.dispatch_capacity(48, cfg)
    whole = seen[0].reshape(E, 4, cap, cfg.d_model)
    mesh = _mesh_shape("data_model")
    for r, pr in enumerate(ranks):
        got = pr["layer"][dispatch]
        c = S.rank_coords(mesh, r)
        rows = slice(2 * c["data"], 2 * c["data"] + 2)
        assert got["experts"] == (2, cfg.d_model, cfg.d_ff)
        assert torch.equal(got["xe"].reshape(2, 2, cap, cfg.d_model),
                           whole[2 * c["model"]:2 * c["model"] + 2, rows])
        blk = want[rows, 24 * c["model"]:24 * c["model"] + 24]
        assert torch.allclose(got["out"], blk, rtol=0, atol=1e-5)
        assert torch.equal(got["counts"], counts[rows])


def test_each_rank_holds_its_part(ranks):
    """No rank holds all experts or the whole cache: each rank's expert
    leaves are (L, E / tp, d or ``d_ff`` / dp, ...) and its cache leaves
    exactly its ``local_index`` part under ``cache_specs`` (the ``moe``
    leaf whole: replicated), on both branches (B 4, B 1)."""
    for name in ("scout", "scout_pod", "maverick", "scout_b1"):
        case = CASES[name]
        cfg = _cfg(case.arch, case.over)
        _, c_specs, _, mesh = _specs(name)
        whole = tree.leaves(steps.abstract_cache(cfg, _shape(case)))
        flat = _spec_leaves(c_specs)
        for r, pr in enumerate(ranks):
            for shape in pr[name]["experts"]:
                assert shape[1] == cfg.n_experts // 2
                assert math.prod(shape[1:]) * 4 == cfg.n_experts * \
                    cfg.d_model * cfg.d_ff
            assert len(pr[name]["parts"]) == len(whole) == len(flat)
            for spec, g, got in zip(flat, whole, pr[name]["parts"]):
                idx = S.local_index(S.P(*spec), g.shape, mesh,
                                    S.rank_coords(mesh, r))
                want = tuple(len(range(*i.indices(n)))
                             for i, n in zip(idx, g.shape))
                assert got == want, (name, r)
                if g.dtype == torch.int32:
                    assert got == tuple(g.shape)       # the moe counts
                else:
                    assert math.prod(got) < g.numel()


def test_the_warnings_are_the_references(ranks):
    """``moe_impl="shard_map"`` prefill warns with the reference's text;
    at B 1 on two data ranks the layer warns of its groups as the
    reference's does; the other cases warn of nothing."""
    ref = _reference("scout_shard_map")["warnings"]
    assert any(m.startswith(SHARD_MAP_WARNING) for m in ref)
    assert any(re.match(GROUPS_WARNING, m)
               for m in _reference("scout_b1")["warnings"])
    for pr in ranks:
        assert [m for m in pr["scout_shard_map"]["warnings"]
                if m.startswith("make_prefill_step")] == \
            [m for m in ref if m.startswith("make_prefill_step")]
        assert any(re.match(GROUPS_WARNING, m)
                   for m in pr["scout_b1"]["warnings"])
        for name in ("scout", "scout_bcsr", "maverick", "scout_drop"):
            assert not [m for m in pr[name]["warnings"] if m.startswith(
                ("apply_moe", "make_prefill_step"))], name


# ---------------------------------------------------- no ranks needed ----

@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
def test_abstract_cache_matches_the_reference(arch):
    """Full size at the reference's decode_32k shape: ``abstract_cache``
    == the reference's ``jax.eval_shape`` leaf for leaf, the MoE counts
    (L, B, E) int32 too."""
    r = _ref()
    shape = ShapeSpec("decode_32k", "decode", 32768, 128)
    got = tree.leaves(steps.abstract_cache(configs.get_config(arch), shape))
    want = r.jax.tree.leaves(r.steps.abstract_cache(
        r.configs.get_config(arch),
        r.ShapeSpec(*dataclasses.astuple(shape))))
    assert len(got) == len(want)
    assert any(a.dtype == torch.int32 for a in got)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


@pytest.mark.parametrize("batch", [4, 1])
@pytest.mark.parametrize("arch", [SCOUT, MAVERICK])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("factory", ["make_prefill_step", "make_serve_step"])
def test_specs_match_the_reference(factory, mesh_name, arch, batch):
    """Each factory's spec triple == the reference's for both MoE
    configs, entry for entry: the experts over "model" and the data axes,
    the replicated ``moe`` counts."""
    r = _ref()
    shape = ShapeSpec("serve", "decode", MAX_SEQ, batch)
    _, ins, outs = getattr(steps, factory)(_cfg(arch), shape,
                                           _mesh_shape(mesh_name))
    _, rins, routs = getattr(r.steps, factory)(
        _cfg(arch, ref=True), r.ShapeSpec(*dataclasses.astuple(shape)),
        r.mesh(mesh_name))
    P = r.jax.sharding.PartitionSpec
    want = [tuple(s) for s in r.jax.tree.leaves(
        (rins, routs), is_leaf=lambda x: isinstance(x, P))]
    assert _spec_leaves((ins, outs)) == want


def test_the_hints_are_the_references(monkeypatch):
    """Both serving steps set the MoE hints as the reference's do:
    ``moe`` ``P("model", dp, None, None)``, ``moe_combine`` ``P(dp, None,
    None)`` and ``moe_groups`` the data axes' ranks for a MoE config, and
    none for a dense one (the steps called on rank 0's coordinates of a
    ``MeshShape``, ``activation_specs`` recording its keywords)."""
    seen = []

    def record(**kw):
        seen.append((kw.get("moe"), kw.get("moe_combine"),
                     kw.get("moe_groups")))
        raise KeyError("recorded")

    monkeypatch.setattr(S, "my_coords",
                        lambda mesh: dict.fromkeys(mesh.mesh_dim_names, 0))
    monkeypatch.setattr(context, "activation_specs", record)
    mesh = _mesh_shape("pod_data_model")
    dp = ("pod", "data")
    moe_hints = (S.P("model", dp, None, None), S.P(dp, None, None), 2)
    shape = _shape(CASES["scout"])
    params = {"embed": torch.zeros(1)}
    for arch, want in ((SCOUT, moe_hints), ("qwen3-1.7b", (None,) * 3)):
        cfg = _cfg(arch)
        prefill, _, _ = steps.make_prefill_step(cfg, shape, mesh)
        serve, (_, c_specs, _, _), _ = steps.make_serve_step(cfg, shape,
                                                             mesh)
        cache = S.local_tree(M.init_cache(cfg, 4, MAX_SEQ, device="cpu"),
                             c_specs, mesh)
        with pytest.raises(KeyError, match="recorded"):
            prefill(params, np.zeros((4, 8), np.int32))
        with pytest.raises(KeyError, match="recorded"):
            serve(params, cache, 0, np.zeros((4, 1), np.int32))
        assert seen[-2:] == [want, want], arch


def test_a_combine_spec_that_splits_the_slots_is_refused():
    """The layer combines whole (B, E*C, d) rows: a ``MOE_COMBINE_SPEC``
    that splits the slots is refused, naming it."""
    cfg = _cfg(SCOUT)
    params = M._take(_params(CASES["scout"])["blocks"][0], 0)["ffn"]
    with context.activation_specs(
            act=S.P("data", None, None), moe=S.P("model", "data", None, None),
            moe_combine=S.P("data", "model", None),
            mesh=_mesh_shape("data_model")):
        with pytest.raises(ValueError, match=r"MOE_COMBINE_SPEC .*splits"):
            moe.apply_moe(params, _layer_x(), cfg)
