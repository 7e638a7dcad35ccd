"""The expert-parallel MoE (``models/moe_shard_map.py``, ``apply_moe``'s
shard_map branch) and the sparse gradient exchange
(``grad_comp.sparse_psum_shard_map``) on gloo ranks on the CPU, vs the
reference and vs the port's one-device layer.

One module-scoped spawn (``parallel.ranks.run_ranks``: 4 ranks, a 60 s
group timeout, the parent waiting at most ``LIMIT`` seconds) runs every
case once: llama4-scout's SMOKE in f32, x (4, 16, 64), on a (2, 2)
("data", "model") mesh and a (1, 2, 2) ("pod", "data", "model") mesh (its
FSDP axes merged), as it is, with a capacity factor of 1.0 (tokens drop),
without the shared expert and with the squared-ReLU MLP; each the forward
and the backward of ``sum(out ** 2)``.  The parent holds:

* the assembled output and every gradient (x, the router, the experts,
  the shared expert) against the reference's ``apply_moe_shard_map`` and
  its ``jax.grad`` on the same mesh shape (conftest's 4 virtual devices,
  ``AxisType.Auto`` axes), within atol = rtol = 1e-5 (a gradient's atol
  in units of its leaf's largest entry, :func:`_grad_close`);
* the assembled output against the port's one-device ``apply_moe`` on each
  (2-row, 8-position) block: ``torch.equal`` on the CPU, where the expert
  products at tp times the rows give the same rows; the gradients against
  the blocks' summed one-device gradients within the same tolerance;
* where each gradient lives: a rank's gradient of a global input is
  complete on its own part (the router's everywhere) and zero elsewhere.

Also the branch in ``apply_moe`` under ``activation_specs``, its warnings
and strict refusals, an unknown backend, ``E % tp``, the merged FSDP group
of a mesh whose equal twin was freed, the hints' save and restore, the groups
check, and ``sparse_psum_shard_map`` (a process group, and a mesh with a
dim name) == ``sparse_allreduce_tree`` == the reference's under
``compat_shard_map``.

The ranks import this file, so the reference (and JAX) is imported by the
parent only, inside :func:`_ref`.
"""
import dataclasses
import functools
import gc
import types
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.grad_comp import sparse_allreduce as SA
from repro_torch.models import moe
from repro_torch.models.moe_shard_map import (apply_moe_shard_map,
                                             local_slices)
from repro_torch.parallel import context
from repro_torch.parallel.ranks import run_ranks

TOL = dict(atol=1e-5, rtol=1e-5)
GROUP_TIMEOUT = 60.0
LIMIT = 120.0
ARCH = "llama4-scout-17b-a16e"
X_SHAPE = (4, 16, 64)
MESHES = {"data_model": ((2, 2), ("data", "model")),
          "pod_data_model": ((1, 2, 2), ("pod", "data", "model"))}
VARIANTS = {"smoke": {}, "drop": dict(capacity_factor=1.0),
            "no_shared": dict(moe_shared_expert=False),
            "relu2": dict(mlp_type="squared_relu")}
CASES = [(m, v) for m in MESHES for v in VARIANTS]
CAUSES = {"counts": dict(counts=torch.zeros((4, 4), dtype=torch.int32)),
          "pos": dict(pos=0), "bcsr": dict(dispatch="bcsr")}
SPARSE_D, SPARSE_K = 256, 16


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (JAX on the CPU; conftest's 4 devices)."""
    import jax
    import jax.numpy as jnp
    from repro import configs
    from repro.grad_comp import sparse_allreduce
    from repro.models import moe as rmoe
    from repro.models import moe_shard_map
    from repro.parallel.sharding import compat_shard_map

    def mesh(shape, names):
        return jax.make_mesh(shape, names, axis_types=(
            jax.sharding.AxisType.Auto,) * len(names))

    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 moe=rmoe, sm=moe_shard_map,
                                 sa=sparse_allreduce,
                                 compat_shard_map=compat_shard_map,
                                 mesh=mesh)


def _dp_axes(names):
    dp = tuple(a for a in ("pod", "data") if a in names)
    return dp if len(dp) > 1 else dp[0]


def _cfg(variant):
    return dataclasses.replace(get_smoke(ARCH), **VARIANTS[variant])


@functools.lru_cache(maxsize=None)
def _inputs(variant):
    """The reference's config, its init_moe params (numpy) and x, from
    seeds."""
    r = _ref()
    cfg = dataclasses.replace(r.configs.get_smoke(ARCH), **VARIANTS[variant])
    rp = r.jax.device_get(r.moe.init_moe(r.jax.random.PRNGKey(7), cfg))
    x = np.random.default_rng(41).standard_normal(X_SHAPE).astype(np.float32)
    return cfg, rp, x


def _torch_params(rp):
    return {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.array(v)))
            for k, v in rp.items()}


def _leaves(p, x):
    """{name: tensor} of the params and x, each a fresh leaf."""
    out = {"x": x}
    for k, v in p.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return {k: v.detach().clone().requires_grad_() for k, v in out.items()}


def _tree(leaves):
    p = {}
    for k, v in leaves.items():
        if k == "x":
            continue
        head, _, tail = k.partition(".")
        if tail:
            p.setdefault(head, {})[tail] = v
        else:
            p[head] = v
    return p, leaves["x"]


def _forward_backward(fn, p, x):
    """``fn(p, x)``'s output and the gradients of ``sum(out ** 2)``."""
    leaves = _leaves(p, x)
    out = fn(*_tree(leaves))
    (out ** 2).sum().backward()
    return out.detach(), {k: v.grad for k, v in leaves.items()}


# ----------------------------------------------------------------- ranks ----

def _rank_cases(rank, world, cases, grads):
    """The ranks' side: every case once, the branch and its refusals, and
    the sparse exchange.  Returns {key: result}."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import axes_group, make_mesh
    meshes = {name: make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
              for name, (shape, names) in MESHES.items()}
    out = {}
    for (mesh_name, variant), (p, x) in cases.items():
        mesh, cfg = meshes[mesh_name], _cfg(variant)
        out[mesh_name, variant] = _forward_backward(
            lambda p, x: apply_moe_shard_map(
                p, x, cfg, mesh, dp_axes=_dp_axes(mesh.mesh_dim_names),
                tp_axis="model"), p, x)
    p, x = cases["data_model", "smoke"]
    cfg, mesh = _cfg("smoke"), meshes["data_model"]
    with context.activation_specs(moe_impl="shard_map", mesh=mesh):
        out["branch"] = moe.apply_moe(p, x, cfg)
        for cause, kw in CAUSES.items():
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got, counts = moe.apply_moe(p, x, cfg, **kw)
            out["warned", cause] = ([str(w.message) for w in caught
                                     if w.category is RuntimeWarning],
                                    got, counts)
            try:
                moe.apply_moe(p, x, dataclasses.replace(
                    cfg, moe_strict_dispatch=True), **kw)
            except ValueError as e:
                out["strict", cause] = str(e)
        try:
            moe.apply_moe(p, x, cfg, dispatch="dense")
        except ValueError as e:
            out["unknown_backend"] = str(e)
    try:
        apply_moe_shard_map(p, x, dataclasses.replace(cfg, n_experts=3),
                            mesh, dp_axes="data", tp_axis="model")
    except ValueError as e:
        out["e_tp"] = str(e)
    # two equal meshes (DeviceMesh compares by value), of a shape no other
    # live mesh has; the first freed, the second keeps its merged group
    shape, names = (2, 1, 2), MESHES["pod_data_model"][1]
    first = make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
    second = make_mesh(shape, names, "cpu", timeout=GROUP_TIMEOUT)
    out["meshes_equal"] = first == second
    del first
    gc.collect()
    try:
        group, n, coord = axes_group(second, ("pod", "data"))
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        out["merged"] = (n, coord, float(t))
    except ValueError as e:
        out["merged"] = str(e)
    g = torch.from_numpy(grads[rank])
    out["psum_group"] = SA.sparse_psum_shard_map(g, SPARSE_K,
                                                 dist.group.WORLD)
    line = make_mesh((world,), ("data",), "cpu", timeout=GROUP_TIMEOUT)
    out["psum_mesh"] = SA.sparse_psum_shard_map(g, SPARSE_K, (line, "data"))
    return out


def _sparse_grads():
    return np.random.default_rng(5).standard_normal(
        (4, SPARSE_D)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks():
    """Each rank's results of :func:`_rank_cases`."""
    cases = {}
    for mesh_name, variant in CASES:
        _, rp, x = _inputs(variant)
        cases[mesh_name, variant] = (_torch_params(rp), torch.from_numpy(x))
    return cases, run_ranks(_rank_cases, 4, cases, _sparse_grads(),
                            timeout=GROUP_TIMEOUT, limit=LIMIT)


def _part(name, shape, mesh_name, rank):
    """The slices of the global leaf ``name`` (of ``shape``) that ``rank``
    holds (row-major meshes: "model" last, the other axes merged into
    dp)."""
    n_tp = MESHES[mesh_name][0][-1]
    i, j = divmod(rank, n_tp)
    return local_slices(name, shape, (4 // n_tp, i), (n_tp, j))


def _assembled(grads_per_rank, name, mesh_name):
    """The global gradient of ``name`` from each rank's own part."""
    out = torch.zeros_like(grads_per_rank[0][name])
    for rank, grads in enumerate(grads_per_rank):
        cut = _part(name, out.shape, mesh_name, rank)
        out[cut] = grads[name][cut]
    return out


def _grad_close(got, want, name):
    """A gradient within ``TOL``, its atol in units of the leaf's largest
    entry: ``sum(out ** 2)``'s gradients reach ~40 at SMOKE, and an entry
    near 0 beside them carries their f32 rounding (the frameworks sum in
    other orders)."""
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=TOL["rtol"],
        atol=TOL["atol"] * float(np.abs(want).max()), err_msg=name)


def _reference(mesh_name, variant):
    """The reference's output and gradients (x, params) on this mesh."""
    r = _ref()
    cfg, rp, x = _inputs(variant)
    shape, names = MESHES[mesh_name]
    mesh = r.mesh(shape, names)

    def fn(p, xx):
        return r.sm.apply_moe_shard_map(p, xx, cfg, mesh,
                                        dp_axes=_dp_axes(names),
                                        tp_axis="model")

    def loss(p, xx):
        return (fn(p, xx) ** 2).sum()

    jp = r.jax.tree_util.tree_map(r.jnp.asarray, rp)
    jx = r.jnp.asarray(x)
    out, (gp, gx) = r.jax.jit(lambda p, xx: (fn(p, xx), r.jax.grad(
        loss, argnums=(0, 1))(p, xx)))(jp, jx)
    grads = {"x": np.asarray(gx)}
    for k, v in gp.items():
        if isinstance(v, dict):
            grads.update({f"{k}.{kk}": np.asarray(vv) for kk, vv in v.items()})
        else:
            grads[k] = np.asarray(v)
    return np.asarray(out), grads


def _one_device(variant):
    """The port's one-device apply_moe on each (2-row, 8-position) block:
    the assembled output and the gradients of the blocks' summed loss."""
    _, rp, x = _inputs(variant)
    cfg = _cfg(variant)
    leaves = _leaves(_torch_params(rp), torch.from_numpy(x))
    p, xx = _tree(leaves)
    out = torch.zeros(X_SHAPE)
    loss = 0
    for i in range(2):
        for j in range(2):
            blk = (slice(2 * i, 2 * i + 2), slice(8 * j, 8 * j + 8))
            o, _ = moe.apply_moe(p, xx[blk], cfg)
            out[blk] = o.detach()
            loss = loss + (o ** 2).sum()
    loss.backward()
    return out, {k: v.grad for k, v in leaves.items()}


# ----------------------------------------------------------------- tests ----

@pytest.mark.parametrize("mesh_name,variant", CASES)
def test_forward_and_gradients_match_reference(ranks, mesh_name, variant):
    """Every rank's assembled output, and every gradient assembled from
    the ranks' own parts, == the reference's shard_map MoE and its
    ``jax.grad`` within 1e-5."""
    _, per_rank = ranks
    got = [pr[mesh_name, variant] for pr in per_rank]
    want_out, want_grads = _reference(mesh_name, variant)
    for out, _ in got:
        assert torch.equal(out, got[0][0])
    np.testing.assert_allclose(got[0][0].numpy(), want_out, **TOL)
    grads = [g for _, g in got]
    assert sorted(grads[0]) == sorted(want_grads)
    for name, want in want_grads.items():
        _grad_close(_assembled(grads, name, mesh_name), want, name)
    if variant == "drop":
        _, rp, x = _inputs(variant)
        keep = moe.route_tokens(torch.from_numpy(np.array(rp["router"])),
                                torch.from_numpy(x[:2, :8]),
                                _cfg(variant)).keep
        assert not keep.all(), "a capacity factor of 1.0 must drop tokens"


@pytest.mark.parametrize("mesh_name,variant", CASES)
def test_blocks_equal_the_one_device_layer(ranks, mesh_name, variant):
    """The assembled output == the port's one-device ``apply_moe`` on each
    block (bitwise on the CPU); the gradients within 1e-5 of the blocks'
    summed one-device gradients."""
    _, per_rank = ranks
    grads = [pr[mesh_name, variant][1] for pr in per_rank]
    want_out, want_grads = _one_device(variant)
    assert torch.equal(per_rank[0][mesh_name, variant][0], want_out)
    for name, want in want_grads.items():
        _grad_close(_assembled(grads, name, mesh_name), want, name)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_each_rank_holds_its_part_of_each_gradient(ranks, mesh_name):
    """A rank's gradient of a global input is zero outside the part it
    holds; ranks that hold the same part (the router everywhere, the
    shared expert over "model") hold the same gradient there."""
    _, per_rank = ranks
    grads = [pr[mesh_name, "smoke"][1] for pr in per_rank]
    for name, g0 in grads[0].items():
        parts = [_part(name, g0.shape, mesh_name, r) for r in range(4)]
        for rank, cut in enumerate(parts):
            g = grads[rank][name].clone()
            held = g[cut].clone()
            assert held.any(), (name, rank)
            g[cut] = 0
            assert not g.any(), (name, rank, "nonzero outside its part")
            for other, o_cut in enumerate(parts):
                if o_cut == cut:
                    assert torch.equal(grads[other][name][cut], held)


def test_apply_moe_takes_the_shard_map_branch(ranks):
    """Under ``activation_specs(moe_impl="shard_map", mesh=...)``
    ``apply_moe`` is the shard_map layer; it returns zero counts."""
    _, per_rank = ranks
    for pr in per_rank:
        out, counts = pr["branch"]
        assert torch.equal(out, pr["data_model", "smoke"][0])
        assert counts.dtype == torch.int32 and counts.shape == (4, 4)
        assert not counts.any()


@pytest.mark.parametrize("cause", sorted(CAUSES))
def test_the_branch_is_train_only(ranks, cause):
    """``counts``, ``pos`` or the bcsr backend under the shard_map impl:
    a RuntimeWarning and the shard_map result (counts handed back), and a
    ValueError under ``moe_strict_dispatch``."""
    _, per_rank = ranks
    for pr in per_rank:
        msgs, out, counts = pr["warned", cause]
        assert len(msgs) == 1 and "train-only" in msgs[0]
        assert torch.equal(out, pr["data_model", "smoke"][0])
        if cause == "counts":
            assert torch.equal(counts, CAUSES["counts"]["counts"])
        assert "train-only" in pr["strict", cause]


def test_the_branch_refuses_an_unknown_backend(ranks):
    _, per_rank = ranks
    for pr in per_rank:
        assert "unknown moe_dispatch backend 'dense'" in pr["unknown_backend"]


def test_merged_group_outlives_an_equal_mesh(ranks):
    """Two equal (2, 1, 2) meshes, the first freed: the second's merged
    ("pod", "data") group is still there and joins the ranks that share a
    "model" coordinate (ranks j and 2 + j)."""
    _, per_rank = ranks
    for rank, pr in enumerate(per_rank):
        assert pr["meshes_equal"]
        assert pr["merged"] == (2, rank // 2, float(2 * (rank % 2) + 2))


def test_experts_must_divide_over_model(ranks):
    _, per_rank = ranks
    for pr in per_rank:
        assert "n_experts 3 does not divide over 2 ranks" in pr["e_tp"]


@functools.lru_cache(maxsize=None)
def _reference_psum():
    """Each of 4 devices' ``sparse_psum_shard_map`` result, (4, D)."""
    r = _ref()
    P = r.jax.sharding.PartitionSpec
    fn = r.compat_shard_map(
        lambda gl: r.sa.sparse_psum_shard_map(gl[0], SPARSE_K, "data")[None],
        mesh=r.mesh((4,), ("data",)), in_specs=P("data", None),
        out_specs=P("data", None))
    return np.asarray(r.jax.jit(fn)(r.jnp.asarray(_sparse_grads())))


@pytest.mark.parametrize("form", ["psum_group", "psum_mesh"])
def test_sparse_psum_matches_the_tree_and_the_reference(ranks, form):
    """Every rank's ``sparse_psum_shard_map`` == the port's
    ``sparse_allreduce_tree`` on the stacked gradients, and == the
    reference's ``sparse_psum_shard_map`` under ``compat_shard_map`` on 4
    devices."""
    _, per_rank = ranks
    tree, _ = SA.sparse_allreduce_tree(torch.from_numpy(_sparse_grads()),
                                       SPARSE_K)
    want = _reference_psum()
    for rank, pr in enumerate(per_rank):
        assert torch.equal(pr[form], tree)
        np.testing.assert_array_equal(pr[form].numpy(), want[rank])


def test_activation_specs_restores_every_hint():
    prev = (context.MOE_GROUPS, context.MOE_IMPL, context.MOE_DISPATCH,
            context.MESH)
    assert prev == (None, "pjit", None, None)
    mesh = object()
    with context.activation_specs(moe_groups=2, moe_impl="shard_map",
                                  moe_dispatch="bcsr", mesh=mesh):
        assert (context.MOE_GROUPS, context.MOE_IMPL, context.MOE_DISPATCH,
                context.MESH) == (2, "shard_map", "bcsr", mesh)
        with context.activation_specs():
            assert (context.MOE_GROUPS, context.MOE_IMPL,
                    context.MOE_DISPATCH, context.MESH) == prev
        with pytest.raises(KeyError):
            with context.activation_specs(moe_groups=3, mesh=None):
                raise KeyError("restored on error too")
        assert context.MOE_GROUPS == 2 and context.MESH is mesh
    assert (context.MOE_GROUPS, context.MOE_IMPL, context.MOE_DISPATCH,
            context.MESH) == prev


def test_check_groups_warns_and_raises_when_strict():
    """``groups=`` (or ``MOE_GROUPS``) that does not divide B warns in
    ``apply_moe`` and ``route_moe``, and raises under strict dispatch; the
    result is the ungrouped layer's."""
    _, rp, x = _inputs("smoke")
    p, xt, cfg = _torch_params(rp), torch.from_numpy(x), _cfg("smoke")
    want = moe.apply_moe(p, xt, cfg)[0]
    with pytest.warns(RuntimeWarning, match="apply_moe: 3 dispatch group"):
        got = moe.apply_moe(p, xt, cfg, groups=3)[0]
    assert torch.equal(got, want)
    with context.activation_specs(moe_groups=3):
        with pytest.warns(RuntimeWarning, match="route_moe: 3 dispatch"):
            moe.route_moe(p, xt, cfg)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        moe.apply_moe(p, xt, cfg, groups=2)
    strict = dataclasses.replace(cfg, moe_strict_dispatch=True)
    for fn in (moe.apply_moe, moe.route_moe):
        with pytest.raises(ValueError, match="not divisible"):
            fn(p, xt, strict, groups=3)


def test_default_impl_and_dispatch_hint():
    """With a mesh set but the default impl, ``apply_moe`` is the
    one-device layer; ``MOE_DISPATCH`` picks the backend where no
    ``dispatch=`` is given, and ``dispatch=`` overrides it."""
    _, rp, x = _inputs("smoke")
    p, xt, cfg = _torch_params(rp), torch.from_numpy(x), _cfg("smoke")
    want = moe.apply_moe(p, xt, cfg)[0]
    with context.activation_specs(mesh=object()):
        assert torch.equal(moe.apply_moe(p, xt, cfg)[0], want)
    with context.activation_specs(moe_dispatch="bcsr"):
        assert moe.route_moe(p, xt, cfg)[0].backend == "bcsr"
        assert moe.route_moe(p, xt, cfg,
                             dispatch="gather")[0].backend == "gather"
        assert torch.equal(moe.apply_moe(p, xt, cfg)[0], want)
