"""Port vs reference: the sharding rules (``parallel/sharding.py``).

For every config of the registry at SMOKE, on a ("data", "model") (2, 2)
mesh and a ("pod", "data", "model") (1, 2, 2) mesh, ``param_specs``,
``opt_state_specs``, ``cache_specs`` (at a batch that fills the data axes
and at B 1), ``batch_spec`` (plain and ``seq_shard``) and
``data_axis_size`` equal the reference's, entry by entry.  The reference
gets ``jax.make_mesh`` over conftest's 4 virtual CPU devices and its
shapes from ``jax.eval_shape``; the port gets ``MeshShape``, the axis
names and sizes the rules read, and its own SMOKE params and cache on the
CPU.  Also: the port's ``PartitionSpec`` entries, ``parallel.context``'s
save and restore, and the mesh builders' refusals without a process group.
"""
import functools

import jax
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.steps import abstract_params as r_abstract_params
from repro.models import model as RM
from repro.parallel import sharding as RS

from repro_torch import configs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.parallel import context
from repro_torch.parallel import sharding as S

MESHES = {"data_model": (("data", "model"), (2, 2)),
          "pod_data_model": (("pod", "data", "model"), (1, 2, 2))}
MAX_SEQ = 16


@functools.lru_cache(maxsize=None)
def _ref_mesh(name):
    names, shape = MESHES[name]
    return jax.make_mesh(shape, names)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """(reference params, port params) at SMOKE, shapes only on the
    reference's side."""
    return (r_abstract_params(r_get_smoke(arch)),
            M.init_params(configs.get_smoke(arch), device="cpu"))


def _caches(arch, batch):
    rcfg, cfg = r_get_smoke(arch), configs.get_smoke(arch)
    return (jax.eval_shape(lambda: RM.init_cache(rcfg, batch, MAX_SEQ)),
            M.init_cache(cfg, batch, MAX_SEQ, device="cpu"))


def _pairs(ref, port, path=()):
    """(path, reference leaf, port leaf) of two trees of one structure (a
    port ``PartitionSpec`` is a leaf, not a tuple)."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and set(ref) == set(port), path
        for k in ref:
            yield from _pairs(ref[k], port[k], path + (k,))
    elif isinstance(ref, (tuple, list)) and not isinstance(port, S.P):
        assert isinstance(port, (tuple, list)) and len(ref) == len(port), path
        for i, (r, p) in enumerate(zip(ref, port)):
            yield from _pairs(r, p, path + (str(i),))
    else:
        yield path, ref, port


def _same(ref, port):
    """The two spec trees are equal entry by entry; returns the leaf
    count."""
    n = 0
    for path, r, p in _pairs(ref, port):
        assert isinstance(p, S.PartitionSpec), (path, p)
        assert tuple(p) == tuple(r), (path, tuple(p), tuple(r))
        n += 1
    return n


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_rules_match_reference(arch, mesh_name):
    rmesh = _ref_mesh(mesh_name)
    mesh = S.MeshShape(*MESHES[mesh_name])
    rparams, params = _trees(arch)
    rspecs = RS.param_specs(rparams, rmesh)
    specs = S.param_specs(params, mesh)
    assert _same(rspecs, specs) == len(jax.tree.leaves(rparams))
    ropt, opt = RS.opt_state_specs(rspecs, rmesh), S.opt_state_specs(specs,
                                                                      mesh)
    for field in ("m", "v", "count"):
        _same(getattr(ropt, field), getattr(opt, field))
    dp = S.data_axis_size(mesh)
    assert dp == RS.data_axis_size(rmesh) == 2
    for batch in (dp, 1):
        rcache, cache = _caches(arch, batch)
        _same(RS.cache_specs(rcache, r_get_smoke(arch), rmesh, batch=batch),
              S.cache_specs(cache, configs.get_smoke(arch), mesh,
                            batch=batch))
        for seq_shard in (False, True):
            assert tuple(S.batch_spec(batch, mesh, seq_shard=seq_shard)) \
                == tuple(RS.batch_spec(batch, rmesh, seq_shard=seq_shard))


def test_spec_entries_and_filter():
    """Entries are a PartitionSpec's: a name, a tuple of names, None; an
    axis the mesh lacks is dropped, a one-name tuple collapses."""
    spec = S.P(None, ("pod", "data"), "model")
    assert isinstance(spec, tuple) and tuple(spec) == (
        None, ("pod", "data"), "model")
    one_pod = S.MeshShape(("data", "model"), (4, 2))
    assert tuple(S._filter(spec, one_pod)) == (None, "data", "model")
    no_model = S.MeshShape(("pod", "data"), (2, 2))
    assert tuple(S._filter(spec, no_model)) == (None, ("pod", "data"), None)
    assert repr(S.P("data")) == "PartitionSpec('data',)"
    assert S.axis_sizes(one_pod) == {"data": 4, "model": 2}
    assert S.data_axis_size(S.MeshShape(("pod", "data", "model"),
                                        (2, 4, 2))) == 8


def test_context_saves_and_restores_the_mesh():
    assert context.MESH is None
    outer, inner = object(), object()
    with mesh_mod.mesh_context(outer):
        assert context.MESH is outer
        with context.activation_specs(mesh=inner):
            assert context.MESH is inner
        assert context.MESH is outer
        with pytest.raises(KeyError):
            with mesh_mod.mesh_context(inner):
                raise KeyError("restored on error too")
        assert context.MESH is outer
    assert context.MESH is None


def test_mesh_builders_need_a_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_host_mesh(data=2, model=2, device_type="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")


def test_smoke_trees_have_the_reference_shapes():
    """The rules read only paths and shapes: the port's SMOKE params and
    caches have the reference's, leaf for leaf (so equal specs are not a
    coincidence of names)."""
    for arch in configs.ARCH_NAMES:
        for ref, port in (_trees(arch), _caches(arch, 2)):
            for path, r, p in _pairs(ref, port):
                assert isinstance(p, torch.Tensor), (arch, path)
                assert tuple(p.shape) == tuple(r.shape), (arch, path)
