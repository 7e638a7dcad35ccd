"""Hints that sharded code reads when its caller passes none.

* ``MESH``: a ``torch.distributed.device_mesh.DeviceMesh`` (or ``None``);
  ``kernels.engine.auto_mesh``, ``models.layers.sharded_flash_attention``
  and ``models.moe.apply_moe``'s shard_map branch read it.
* ``MOE_IMPL``: ``"pjit"`` (the one-device layer, the default) or
  ``"shard_map"`` (with a ``MESH``: ``models.moe_shard_map``, the
  train-only expert-parallel layer).
* ``MOE_DISPATCH``: ``"gather"`` | ``"bcsr"`` | ``None`` (the config's
  ``moe_dispatch``), read by ``models.moe`` where no ``dispatch=`` is
  given.
* ``MOE_GROUPS``: the dispatch row groups the data axes expect; routing is
  per batch row, so ``models.moe`` only checks that it divides the batch.

:func:`activation_specs` sets all four for a scope and restores the
previous values after, as the reference's does.  The reference's GSPMD
constraints (``ACT_SPEC``, ``MOE_SPEC``, ``LOGIT_SPEC``,
``MOE_COMBINE_SPEC``) have no reader in the port yet.
"""
from __future__ import annotations

import contextlib
from typing import Optional

MOE_GROUPS: Optional[int] = None
MOE_IMPL: str = "pjit"                # "pjit" | "shard_map"
MOE_DISPATCH: Optional[str] = None    # "gather" | "bcsr" | None (= cfg field)
MESH = None


@contextlib.contextmanager
def activation_specs(*, moe_groups: Optional[int] = None,
                     moe_impl: str = "pjit",
                     moe_dispatch: Optional[str] = None, mesh=None):
    """The four hints set inside the ``with`` block, the previous values
    after (also when the block raises)."""
    global MOE_GROUPS, MOE_IMPL, MOE_DISPATCH, MESH
    prev = (MOE_GROUPS, MOE_IMPL, MOE_DISPATCH, MESH)
    MOE_GROUPS, MOE_IMPL, MOE_DISPATCH, MESH = (moe_groups, moe_impl,
                                                moe_dispatch, mesh)
    try:
        yield
    finally:
        MOE_GROUPS, MOE_IMPL, MOE_DISPATCH, MESH = prev
