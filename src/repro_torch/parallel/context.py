"""The mesh that sharded code reads when its caller passes none.

``MESH`` is a ``torch.distributed.device_mesh.DeviceMesh`` (or ``None``):
``kernels.engine.auto_mesh`` and ``models.layers.sharded_flash_attention``
read it.  :func:`activation_specs` sets it for a scope and restores the
previous value after, as the reference's does; the reference's pjit hints
(``ACT_SPEC``, ``MOE_SPEC`` and the rest) have no reader in the port yet.
"""
from __future__ import annotations

import contextlib

MESH = None


@contextlib.contextmanager
def activation_specs(*, mesh=None):
    """``MESH = mesh`` inside the ``with`` block, the previous value after."""
    global MESH
    prev = MESH
    MESH = mesh
    try:
        yield
    finally:
        MESH = prev
