"""Device meshes on ``torch.distributed``: the reference's
``repro/launch/mesh.py`` (single-pod 16 x 16, multi-pod 2 x 16 x 16, and
small host meshes for tests and demos).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group's ranks, which the caller initialises first
(``torch.distributed.init_process_group``: an address or a store, the world
size, this rank).  Each mesh dim's groups take the caller's ``timeout``
(seconds; None: torch's default for the backend); a dim over every rank is
the default group itself.  A mesh with both FSDP axes ("pod" and "data")
also gets, with the same timeout, the group of the two merged (the ranks
that share every other coordinate), which :func:`axes_group` hands to the
expert-parallel MoE.  ``device_type`` is "cuda" unless the caller asks
for "cpu".  Functions, not constants: importing this module touches no
process group.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.parallel import context
from repro_torch.parallel.sharding import FSDP

# the mesh's attribute that holds {merged axes: their process group}, set
# by make_mesh on the mesh object itself: DeviceMesh compares and hashes by
# value, so two equal meshes must not share a table entry
_MERGED = "_merged_axes_groups"


def _rows(ranks: torch.Tensor, dims) -> list:
    """The rank lists that share every coordinate but ``dims``', each in
    the merged coordinate's order (``dims`` row-major)."""
    rest = [d for d in range(ranks.dim()) if d not in dims]
    n = math.prod(ranks.shape[d] for d in dims)
    return ranks.permute(*rest, *dims).reshape(-1, n).tolist()


def make_mesh(shape, names, device_type: str = "cuda", *,
              timeout: Optional[float] = None):
    """A ``shape`` mesh with axes ``names`` over the default group's ranks
    in row-major order.  Raises, naming the ranks it needs, when there is no
    group or the world is another size."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} {names} mesh needs the default process group: call "
            "torch.distributed.init_process_group first")
    need, have = math.prod(shape), dist.get_world_size()
    if have != need:
        raise RuntimeError(f"a {shape} {names} mesh needs {need} ranks; "
                           f"the world has {have}")
    from torch.distributed.device_mesh import DeviceMesh
    td = None if timeout is None else datetime.timedelta(seconds=timeout)
    ranks = torch.arange(need).view(tuple(shape))

    def group(dims):
        if math.prod(shape[d] for d in dims) == need:
            return dist.group.WORLD
        return dist.new_subgroups_by_enumeration(_rows(ranks, dims),
                                                 timeout=td)[0]

    mesh = DeviceMesh.from_group([group((d,)) for d in range(len(shape))],
                                 device_type, ranks,
                                 mesh_dim_names=tuple(names))
    fsdp = tuple(a for a in FSDP if a in names)
    setattr(mesh, _MERGED, {fsdp: group([names.index(a) for a in fsdp])}
            if len(fsdp) > 1 else {})
    return mesh


def axes_group(mesh, axes: Union[str, Tuple[str, ...]]):
    """(process group, size, this rank's coordinate) of the mesh axis
    ``axes``, or of the axes merged (row-major, as a tuple of names does in
    a ``PartitionSpec``): the merged FSDP axes' group is the one
    :func:`make_mesh` built; one axis is the mesh's own dim."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    coord = 0
    for a in names:
        coord = coord * sizes[a] + mesh.get_local_rank(a)
    n = math.prod(sizes[a] for a in names)
    if len(names) == 1:
        return mesh.get_group(names[0]), n, coord
    merged = getattr(mesh, _MERGED, {})
    if names not in merged:
        raise ValueError(f"no merged group of the axes {names} on this mesh "
                         f"(make_mesh builds one for {FSDP})")
    return merged[names], n, coord


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda",
                         timeout: Optional[float] = None):
    """16 x 16 ("data", "model") a pod; 2 x 16 x 16 ("pod", "data",
    "model") for the dual-pod system.  Raises, naming the ranks it needs,
    when the world is another size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type, timeout=timeout)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1, *,
                   device_type: str = "cuda",
                   timeout: Optional[float] = None):
    """A small ("data", "model") mesh, or ("pod", "data", "model") when
    ``pod > 1``, over the default group's ranks."""
    if pod > 1:
        return make_mesh((pod, data, model), ("pod", "data", "model"),
                         device_type, timeout=timeout)
    return make_mesh((data, model), ("data", "model"), device_type,
                     timeout=timeout)


def mesh_context(mesh):
    """``parallel.context.MESH = mesh`` for the ``with`` block."""
    return context.activation_specs(mesh=mesh)
