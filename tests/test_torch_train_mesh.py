"""The multi-rank train step (``launch.steps.make_train_step(mesh=)``) on
gloo ranks on the CPU, vs the reference's sharded step and vs the port's
one-device step.

One module-scoped spawn (``parallel.ranks.run_ranks``: 4 ranks, a 60 s
group timeout) runs every case: qwen3-1.7b's and llama4-scout's SMOKE
configs (scout under ``moe_impl="shard_map"``) in f32 at
``ShapeSpec("tiny_train", "train", 32, 4)`` with ``seq_chunk=16`` and
AdamW at a constant lr of 1e-3 (clipping at 1.0 bites: the norms are
about 3), on a (2, 2) ("data", "model") mesh and a (1, 2, 2) ("pod",
"data", "model") mesh, three steps each; then one step of each variant:
``seq_parallel=False``, ``microbatches=2``, ``attn_impl=
"kernel_sharded"`` (on the CPU K3's plain version, through the
one-device call on the rank's heads), the default ``seq_chunk`` (512,
which takes the loss's unchunked branch), a padded vocabulary (300 of 512
ids), and gemma3-12b (local / global layers), qwen2-1.5b (qkv biases),
nemotron-4-340b (squared ReLU, 6 heads) and llama4-maverick (attn and
attn+moe interleaved).  Each rank cuts the global params and AdamW state
with ``sharding.local_tree`` by the step's specs; the parent assembles
the ranks' parts with ``sharding.assemble`` (which also checks that the
copies of a replicated part are equal).  The weights are the reference's
``init_params`` (numpy) through ``interop.params_from_jax(train=True)``.

Tolerances: atol = rtol = 1e-5 on the loss and the norm; on AdamW's
``m`` and ``v`` 1e-5 in units of the leaf's largest entry; on the params
the same plus an absolute 2 x lr (AdamW's normalised step can flip sign
on a near-zero gradient whose sum order changed).  :func:`_close` prints
the leaves that needed the second term.

The ranks import this file, so JAX is imported by the parent only,
inside :func:`_ref`.
"""
import dataclasses
import functools
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.interop import params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel import context
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks

torch.set_num_threads(2)
TOL = 1e-5
LR = 1e-3
GROUP_TIMEOUT = 60.0
LIMIT = 240.0
SHAPE = ShapeSpec("tiny_train", "train", 32, 4)
SEQ_CHUNK = 16
QWEN, SCOUT = "qwen3-1.7b", "llama4-scout-17b-a16e"
SM = {"moe_impl": "shard_map"}
MESHES = {"data_model": ((2, 2), ("data", "model")),
          "pod_data_model": ((1, 2, 2), ("pod", "data", "model"))}
# name -> (arch, config overrides, mesh, make_train_step keywords, steps)
CASES = {
    "qwen3": (QWEN, (), "data_model", {}, 3),
    "qwen3_pod": (QWEN, (), "pod_data_model", {}, 3),
    "scout": (SCOUT, (), "data_model", SM, 3),
    "scout_pod": (SCOUT, (), "pod_data_model", SM, 3),
    "qwen3_no_sp": (QWEN, (), "data_model", {"seq_parallel": False}, 1),
    "scout_no_sp": (SCOUT, (), "data_model",
                    {**SM, "seq_parallel": False}, 1),
    "qwen3_mb2": (QWEN, (), "data_model", {"microbatches": 2}, 1),
    "scout_mb2": (SCOUT, (), "data_model", {**SM, "microbatches": 2}, 1),
    "qwen3_kernel": (QWEN, (), "data_model",
                     {"attn_impl": "kernel_sharded"}, 1),
    # the default seq_chunk (512 >= S - 1): the loss's unchunked branch
    "qwen3_unchunked": (QWEN, (), "data_model", {"seq_chunk": 512}, 1),
    "qwen3_pad": (QWEN, (("vocab_size", 300),), "data_model", {}, 1),
    "gemma3": ("gemma3-12b", (), "data_model", {}, 1),
    "qwen2": ("qwen2-1.5b", (), "data_model", {}, 1),
    "nemotron": ("nemotron-4-340b", (), "data_model", {}, 1),
    "maverick": ("llama4-maverick-400b-a17b", (), "data_model", SM, 1),
}
# each variant against its base case (step 1)
VARIANTS = {"qwen3_no_sp": "qwen3", "scout_no_sp": "scout",
            "qwen3_mb2": "qwen3", "scout_mb2": "scout",
            "qwen3_kernel": "qwen3"}


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (JAX on the CPU; conftest's 4 devices)."""
    import jax
    from jax.sharding import NamedSharding
    from repro import configs as rconfigs
    from repro.launch import steps as rsteps
    from repro.launch.shapes import ShapeSpec as RShapeSpec
    from repro.models import model as RM
    from repro.optim import adamw as RA

    def mesh(name):
        shape, names = MESHES[name]
        return jax.make_mesh(shape, names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(names))

    return types.SimpleNamespace(jax=jax, NamedSharding=NamedSharding,
                                 configs=rconfigs, steps=rsteps, RM=RM,
                                 RA=RA, mesh=mesh,
                                 shape=RShapeSpec(*dataclasses.astuple(
                                     SHAPE)))


def _cfg(arch, overrides=(), ref=False):
    get = _ref().configs.get_smoke if ref else configs.get_smoke
    return dataclasses.replace(get(arch), policy="f32", **dict(overrides))


@functools.lru_cache(maxsize=None)
def _weights(arch, overrides=()):
    """The reference's init_params (seed 0) as numpy."""
    r = _ref()
    rcfg = _cfg(arch, overrides, ref=True)
    return r.jax.device_get(r.jax.jit(r.RM.init_params, static_argnums=1)(
        r.jax.random.PRNGKey(0), rcfg))


def _params(arch, overrides=()):
    return params_from_jax(_weights(arch, overrides),
                           _cfg(arch, overrides), device="cpu", train=True)


def _tokens(cfg, n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (SHAPE.global_batch,
                                              SHAPE.seq_len)).astype(np.int32)
            for _ in range(n)]


def _mesh_shape(name):
    shape, names = MESHES[name]
    return S.MeshShape(names, shape)


# ----------------------------------------------------------------- ranks ----

def _rank_cases(rank, world, cases):
    """The ranks' side: every case's steps; the call-time refusals."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {name: make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    out = {}
    for name, (params, toks) in cases.items():
        arch, over, mesh_name, kw, _ = CASES[name]
        mesh = meshes[mesh_name]
        opt = AdamW(lr=LR)
        step, (p_specs, o_specs, _, _), _ = steps.make_train_step(
            _cfg(arch, over), SHAPE, opt, mesh=mesh,
            **{"seq_chunk": SEQ_CHUNK, **kw})
        local = S.local_tree(params, p_specs, mesh)
        state = S.local_tree(opt.init(params), o_specs, mesh)
        metrics, after = [], []
        for tok in toks:
            local, state, m = step(local, state, tok)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            after.append((local, state))
        out[name] = {"metrics": metrics, "first": after[0],
                     "last": after[-1]}
    params, toks = cases["qwen3"]
    opt = AdamW(lr=LR)
    step, (p_specs, o_specs, _, _), _ = steps.make_train_step(
        _cfg(QWEN), SHAPE, opt, seq_chunk=SEQ_CHUNK,
        mesh=meshes["data_model"])
    local = S.local_tree(params, p_specs, meshes["data_model"])
    state = S.local_tree(opt.init(params), o_specs, meshes["data_model"])
    for what, args in (("embeddings", (toks[0], np.zeros((4, 2, 64)))),
                       ("batch", (toks[0][:3],)),
                       ("sequence", (toks[0][:, :31],))):
        try:
            step(local, state, *args)
        except ValueError as e:
            out["refused", what] = str(e)
    return out


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of :func:`_rank_cases`."""
    cases = {}
    for name, (arch, over, _, _, n) in CASES.items():
        cases[name] = (_params(arch, over), _tokens(_cfg(arch, over), n))
    return run_ranks(_rank_cases, 4, cases, timeout=GROUP_TIMEOUT,
                     limit=LIMIT)


def _specs(name):
    arch, over, mesh_name, _, _ = CASES[name]
    p_specs = S.param_specs(steps.abstract_params(_cfg(arch, over)),
                            _mesh_shape(mesh_name))
    return p_specs, AdamWState(m=p_specs, v=p_specs, count=S.P(),
                               master=None)


def _assembled(per_rank, name, when):
    """(params, state) after step 1 (``when`` "first") or the last step,
    assembled from the ranks' parts."""
    p_specs, o_specs = _specs(name)
    mesh = _mesh_shape(CASES[name][2])
    parts = [pr[name][when] for pr in per_rank]
    return (S.assemble([p for p, _ in parts], p_specs, mesh),
            S.assemble([s for _, s in parts], o_specs, mesh))


@functools.lru_cache(maxsize=None)
def _one_device(name):
    """The port's one-device step from the same params on the same
    tokens: [(loss, norm)], (params, state) after step 1 and the last."""
    arch, over, _, kw, n = CASES[name]
    cfg = _cfg(arch, over)
    params = _params(arch, over)
    opt = AdamW(lr=LR)
    step = steps.make_train_step(
        cfg, SHAPE, opt, seq_chunk=kw.get("seq_chunk", SEQ_CHUNK),
        microbatches=kw.get("microbatches"), attn_impl=kw.get("attn_impl"))
    state = opt.init(params)
    metrics, after = [], []
    for tok in _tokens(cfg, n):
        params, state, m = step(params, state, tok)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        after.append((params, state))
    return metrics, after[0], after[-1]


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's ``jax.jit(make_train_step(cfg, shape, mesh))`` one
    step on this case's mesh: (loss, norm), params, state (numpy)."""
    r = _ref()
    arch, over, mesh_name, kw, _ = CASES[name]
    rcfg = _cfg(arch, over, ref=True)
    mesh = r.mesh(mesh_name)
    opt = r.RA.AdamW(lr=LR)
    fn, (p_specs, o_specs, tok_spec, _), _ = r.steps.make_train_step(
        rcfg, r.shape, mesh, opt, **{"seq_chunk": SEQ_CHUNK, **kw})
    P = r.jax.sharding.PartitionSpec
    weights = _weights(arch, over)

    def put(x, spec):
        return x if spec is None else r.jax.device_put(
            x, r.NamedSharding(mesh, spec))

    leaf = lambda x: isinstance(x, P) or x is None  # noqa: E731
    params = r.jax.tree.map(lambda s, x: put(x, s), p_specs, weights,
                            is_leaf=leaf)
    state = r.jax.tree.map(lambda s, x: put(x, s), o_specs,
                           opt.init(weights), is_leaf=leaf)
    tok = put(_tokens(_cfg(arch, over), 1)[0], tok_spec)
    p, s, m = r.jax.jit(fn)(params, state, tok)
    return ((float(m["loss"]), float(m["grad_norm"])),
            r.jax.device_get(p), r.jax.device_get(s))


def _paths(node, path=()) -> list:
    """The leaves' paths of a param tree in ``tree.leaves`` order."""
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _paths(node[k], path + (k,))]
    if isinstance(node, (tuple, list)):
        return [p for i, v in enumerate(node)
                for p in _paths(v, path + (str(i),))]
    return ["/".join(path)]


def _close(got, want, what, params=False) -> list:
    """Every leaf of ``got`` within TOL of ``want`` in units of the leaf's
    largest |want| (plus 2 x LR for ``params``); returns (and prints) the
    leaves that needed the 2 x LR term, with their number of such
    elements."""
    names = _paths(got)
    got, want = tree.leaves(got), [np.asarray(w, dtype=np.float32)
                                   for w in tree.leaves(want)]
    assert len(got) == len(want), what
    second = []
    for name, a, b in zip(names, got, want):
        a = a.float().numpy()
        assert a.shape == b.shape, (what, name)
        atol = TOL * float(np.abs(b).max())
        err = np.abs(a - b) - TOL * np.abs(b)
        if params and (err > atol).any():
            second.append((name, int((err > atol).sum()), b.size))
            atol += 2 * LR
        assert (err <= atol).all(), (what, name, float(err.max()), atol)
    if second:
        print(f"{what}: the 2 x lr term for {second}")
    return second


def _metrics_close(got, want, what):
    for (l1, n1), (l2, n2) in zip(got, want):
        assert abs(l1 - l2) <= TOL + TOL * abs(l2), (what, l1, l2)
        assert abs(n1 - n2) <= TOL + TOL * abs(n2), (what, n1, n2)


# ----------------------------------------------------------------- tests ----

@pytest.mark.parametrize("name", ["qwen3", "scout", "qwen3_unchunked"])
def test_matches_the_reference_sharded_step(ranks, name):
    """Step 1 on the (2, 2) mesh: loss, norm, the assembled params and
    AdamW state == the reference's jitted sharded step (chunked at 16
    positions, and unchunked at the default ``seq_chunk``)."""
    (loss, norm), rp, rs = _reference(name)
    _metrics_close(ranks[0][name]["metrics"][:1], [(loss, norm)], name)
    params, state = _assembled(ranks, name, "first")
    _close(state.m, rs.m, f"{name} m")
    _close(state.v, rs.v, f"{name} v")
    assert int(state.count) == int(rs.count) == 1
    _close(params, rp, f"{name} params", params=True)


@pytest.mark.parametrize("name", ["qwen3", "scout"])
def test_pod_mesh_matches_the_data_model_mesh(ranks, name):
    """The (1, 2, 2) mesh (FSDP over ("pod", "data") merged) == the
    (2, 2) mesh's result: losses and norms of all steps, params and
    state after step 1 and the last."""
    pod = f"{name}_pod"
    _metrics_close(ranks[0][pod]["metrics"], ranks[0][name]["metrics"], pod)
    for when in ("first", "last"):
        p, s = _assembled(ranks, pod, when)
        wp, ws = _assembled(ranks, name, when)
        _close(s.m, [t.numpy() for t in tree.leaves(ws.m)], f"{pod} m")
        _close(s.v, [t.numpy() for t in tree.leaves(ws.v)], f"{pod} v")
        _close(p, [t.numpy() for t in tree.leaves(wp)], f"{pod} params",
               params=True)


@pytest.mark.parametrize("name", ["qwen3", "qwen3_pod", "scout",
                                  "scout_pod"])
def test_trajectory_matches_one_device(ranks, name):
    """Three steps: losses, norms and the assembled params == the port's
    one-device step."""
    metrics, _, (params, state) = _one_device(name)
    _metrics_close(ranks[0][name]["metrics"], metrics, name)
    p, s = _assembled(ranks, name, "last")
    _close(p, [t.numpy() for t in tree.leaves(params)], f"{name} params",
           params=True)
    _close(s.m, [t.numpy() for t in tree.leaves(state.m)], f"{name} m")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_matches_its_base(ranks, name):
    """``seq_parallel=False``, ``microbatches=2`` and ``kernel_sharded``
    against the base case's step 1 (and against the one-device step)."""
    base = VARIANTS[name]
    _metrics_close(ranks[0][name]["metrics"],
                   ranks[0][base]["metrics"][:1], name)
    for want_p, want_s in (_assembled(ranks, base, "first"),
                           _one_device(name)[1]):
        p, s = _assembled(ranks, name, "first")
        _close(s.m, [t.numpy() for t in tree.leaves(want_s.m)], f"{name} m")
        _close(s.v, [t.numpy() for t in tree.leaves(want_s.v)], f"{name} v")
        _close(p, [t.numpy() for t in tree.leaves(want_p)],
               f"{name} params", params=True)


@pytest.mark.parametrize("name", ["qwen3_pad", "gemma3", "qwen2",
                                  "nemotron", "maverick"])
def test_other_configs_match_one_device(ranks, name):
    """A padded vocabulary (ids 300-511 masked on the rank that holds
    them), local / global layers, qkv biases, squared ReLU with 6 heads,
    and attn / attn+moe interleaved: step 1 == the one-device step."""
    metrics, (params, state), _ = _one_device(name)
    _metrics_close(ranks[0][name]["metrics"], metrics, name)
    p, s = _assembled(ranks, name, "first")
    _close(s.m, [t.numpy() for t in tree.leaves(state.m)], f"{name} m")
    _close(p, [t.numpy() for t in tree.leaves(params)], f"{name} params",
           params=True)


def test_loss_and_norm_are_equal_on_every_rank(ranks):
    for name in CASES:
        assert all(pr[name]["metrics"] == ranks[0][name]["metrics"]
                   for pr in ranks), name


def test_layer_params_runs_inside_each_layers_remat():
    """``model.loss_fn(layer_params=)``, the hook through which the
    sharded step gathers a layer's shards: called once a layer in the
    forward and once more in the backward's recompute, in layer order;
    an identity hook changes neither the loss nor the gradients."""
    from repro_torch.models import model as M
    cfg = _cfg(QWEN)
    params = M.init_params(cfg, seed=0, device="cpu",
                           param_dtype=torch.float32)
    tok = torch.from_numpy(_tokens(cfg, 1)[0])
    calls = []

    def hook(where, p):
        calls.append(where)
        return p

    out = [steps.value_and_grad(lambda p: M.loss_fn(
        p, tok, cfg, seq_chunk=SEQ_CHUNK, layer_params=lp), params)
        for lp in (None, hook)]
    order = [j for _ in range(cfg.n_repeats)
             for j in range(len(cfg.block_unit))]
    assert calls[:len(order)] == order
    assert sorted(calls[len(order):]) == sorted(order)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(out[0][1]),
                                                 tree.leaves(out[1][1])))


class _Spec:
    """A spec wrapped so that ``tree.leaves`` takes it as one leaf."""

    def __init__(self, spec):
        self.spec = tuple(spec)


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``jax.tree.leaves`` order."""
    return [w.spec for w in tree.leaves(S.map_specs(lambda _, s: _Spec(s),
                                                    specs))]


@pytest.mark.parametrize("name", ["qwen3", "scout_pod"])
def test_each_rank_holds_its_part(ranks, name):
    """Each rank's params and moments are exactly its ``local_index``
    part of every leaf; the distinct parts add up to the global size, and
    no rank holds the whole of a sharded leaf."""
    p_specs, _ = _specs(name)
    mesh = _mesh_shape(CASES[name][2])
    glob = tree.leaves(steps.abstract_params(_cfg(*CASES[name][:2])))
    specs = _spec_leaves(p_specs)
    for held in ("params", "m", "v"):
        shapes = []
        for pr in ranks:
            params, state = pr[name]["last"]
            local = {"params": params, "m": state.m, "v": state.v}[held]
            shapes.append([tuple(t.shape) for t in tree.leaves(local)])
        for i, (spec, g) in enumerate(zip(specs, glob)):
            parts = set()
            for r in range(4):
                idx = S.local_index(S.P(*spec), g.shape, mesh,
                                    S.rank_coords(mesh, r))
                ranges = tuple(range(*s.indices(n))
                               for s, n in zip(idx, g.shape))
                assert shapes[r][i] == tuple(map(len, ranges)), (held, i, r)
                parts.add(tuple((x.start, x.stop) for x in ranges))
            assert sum(math.prod(b - a for a, b in part)
                       for part in parts) == g.numel(), (held, i)
            if any(e is not None for e in spec):
                assert all(math.prod(sh[i]) < g.numel() for sh in shapes)


@pytest.mark.parametrize("arch", [QWEN, SCOUT])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_specs_match_the_reference(arch, mesh_name):
    """``make_train_step(mesh=)``'s spec triple == the reference's, entry
    for entry."""
    r = _ref()
    kw = SM if arch == SCOUT else {}
    _, ins, outs = steps.make_train_step(
        _cfg(arch), SHAPE, AdamW(lr=LR), mesh=_mesh_shape(mesh_name), **kw)
    _, rins, routs = r.steps.make_train_step(
        _cfg(arch, ref=True), r.shape, r.mesh(mesh_name),
        r.RA.AdamW(lr=LR), **kw)
    P = r.jax.sharding.PartitionSpec
    want = [tuple(s) for s in r.jax.tree.leaves(
        (rins, routs), is_leaf=lambda x: isinstance(x, P))]
    assert _spec_leaves((ins, outs)) == want
    assert isinstance(ins[1], AdamWState) and ins[1].master is None


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_abstract_params_and_opt_state_match_the_reference(arch):
    """Every arch at full size: ``abstract_params`` /
    ``abstract_opt_state`` (on ``meta``) == the reference's
    ``jax.eval_shape`` leaf for leaf, shapes and dtypes."""
    r = _ref()
    rcfg = r.configs.get_config(arch)
    cfg = configs.get_config(arch)
    for got, want in ((steps.abstract_params(cfg),
                       r.steps.abstract_params(rcfg)),
                      (steps.abstract_opt_state(cfg, steps.default_optimizer()),
                       r.steps.abstract_opt_state(
                           rcfg, r.steps.default_optimizer()))):
        g, w = tree.leaves(got), r.jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), (a.dtype,
                                                                 b.dtype)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_local_tree_and_assemble_round_trip(mesh_name):
    """Cut a param tree and an AdamW state to every rank's parts and put
    them back: ``torch.equal`` leaf for leaf."""
    mesh = _mesh_shape(mesh_name)
    params = _params(SCOUT)
    opt = AdamW(lr=LR, master_weights=True)
    state = opt.init(params)
    state = state._replace(m=tree.map(torch.randn_like, state.m))
    p_specs = S.param_specs(params, mesh)
    o_specs = S.opt_state_specs(p_specs, mesh)._replace(master=p_specs)
    for whole, specs in ((params, p_specs), (state, o_specs)):
        parts = [S.local_tree(whole, specs, mesh, S.rank_coords(mesh, r))
                 for r in range(4)]
        back = S.assemble(parts, specs, mesh)
        for a, b in zip(tree.leaves(back), tree.leaves(whole)):
            assert torch.equal(a, b)


def test_assemble_refuses_copies_that_differ():
    mesh = _mesh_shape("data_model")
    spec = {"w": S.P("data", None)}
    parts = [{"w": torch.full((2, 3), float(r // 2))} for r in range(4)]
    assert torch.equal(S.assemble(parts, spec, mesh)["w"][2:],
                       torch.ones(2, 3))
    parts[1]["w"] = parts[1]["w"] + 1
    with pytest.raises(ValueError, match="w: ranks 0 and 1 hold different"):
        S.assemble(parts, spec, mesh)


def test_local_index_refuses_a_dim_that_does_not_divide():
    mesh = _mesh_shape("pod_data_model")
    with pytest.raises(ValueError, match=r"blocks/0/attn/wq: dim 1 of "
                                         r"\(2, 5, 8\) does not divide over "
                                         r"the 2 ranks"):
        S.local_tree({"blocks": ({"attn": {"wq": torch.zeros(2, 5, 8)}},)},
                     {"blocks": ({"attn": {"wq": S.P(None, ("pod", "data"),
                                                     "model")}},)},
                     mesh, S.rank_coords(mesh, 0))


def test_shardings_are_placements_a_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh_shape("pod_data_model")
    specs = S.param_specs(steps.abstract_params(_cfg(SCOUT)), mesh)
    pl = S.shardings(specs, mesh)
    assert pl["embed"] == (Shard(1), Shard(1), Shard(0))
    assert pl["unembed"] == (Shard(0), Shard(0), Shard(1))
    assert pl["final_norm"]["scale"] == (Replicate(),) * 3
    ffn = pl["blocks"][0]["ffn"]
    assert ffn["experts"]["w_down"] == (Shard(3), Shard(3), Shard(1))
    assert ffn["router"] == (Shard(1), Shard(1), Replicate())


def test_activation_specs_restores_all_eight_hints():
    names = ("ACT_SPEC", "MOE_SPEC", "LOGIT_SPEC", "MOE_GROUPS",
             "MOE_COMBINE_SPEC", "MOE_IMPL", "MOE_DISPATCH", "MESH")
    read = lambda: tuple(getattr(context, n) for n in names)  # noqa: E731
    assert read() == (None, None, None, None, None, "pjit", None, None)
    outer = (S.P("data", "model", None), S.P("model", "data", None, None),
             S.P("data", None, "model"), 2, S.P("data", None, None),
             "shard_map", "gather", object())
    with context.activation_specs(*outer):
        assert read() == outer
        with pytest.raises(KeyError):
            with context.activation_specs(act=S.P(None, None, None),
                                          mesh=None):
                assert context.ACT_SPEC == S.P(None, None, None)
                raise KeyError("restored on error too")
        assert read() == outer
    assert read() == (None, None, None, None, None, "pjit", None, None)


REFUSALS = {
    "rwkv": ("rwkv6-7b", (), {}, r"\['rwkv'\] layers.*item 4b\.4"),
    "mamba": ("zamba2-1.2b", (), {}, r"\['mamba'\] layers.*item 4b\.4"),
    "shared_attn": (QWEN, (("shared_attn_every", 1),), {},
                    r"shared attention block.*item 4b\.6"),
    "frontend": ("musicgen-large", (), {},
                 r"frontend 'audio' embeddings.*item 4b\.5"),
    "tied": (QWEN, (("tie_embeddings", True),), {},
             r"tied embeddings.*item 4b\.7"),
    "pjit_moe": (SCOUT, (), {}, r"moe_impl='pjit'.*item 4b\.8"),
    "kv_heads": (QWEN, (("n_kv_heads", 1), ("n_heads", 2)), {},
                 r"n_kv_heads 1 does not divide over the 2 ranks"),
}


@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_a_mesh_refuses(what):
    arch, over, kw, match = REFUSALS[what]
    with pytest.raises(ValueError, match=match):
        steps.make_train_step(_cfg(arch, over), SHAPE,
                              mesh=_mesh_shape("data_model"), **kw)


@pytest.mark.parametrize("what,match", [
    ("embeddings", r"frontend embeddings.*item 4b\.5"),
    ("batch", r"the batch 3 does not divide over the 2 ranks of 'data'"),
    ("sequence", r"the sequence 31 does not divide over the 2 ranks of "
                 r"'model'")])
def test_the_step_refuses_inputs_it_cannot_split(ranks, what, match):
    import re
    for pr in ranks:
        assert re.search(match, pr["refused", what]), pr["refused", what]
