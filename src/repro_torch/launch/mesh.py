"""Device meshes on ``torch.distributed``: the reference's
``repro/launch/mesh.py`` (single-pod 16 x 16, multi-pod 2 x 16 x 16, and
small host meshes for tests and demos).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group's ranks, which the caller initialises first
(``torch.distributed.init_process_group``: an address or a store, the world
size, this rank).  Each mesh dim's groups take the caller's ``timeout``
(seconds; None: torch's default for the backend); a dim over every rank is
the default group itself.  ``device_type`` is "cuda" unless the caller asks
for "cpu".  Functions, not constants: importing this module touches no
process group.
"""
from __future__ import annotations

import datetime
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.parallel import context


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
    groups = []
    for d, n in enumerate(shape):
        if n == need:
            groups.append(dist.group.WORLD)
            continue
        rows = ranks.movedim(d, -1).reshape(-1, n).tolist()
        groups.append(dist.new_subgroups_by_enumeration(rows, timeout=td)[0])
    return DeviceMesh.from_group(groups, device_type, ranks,
                                 mesh_dim_names=tuple(names))


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
