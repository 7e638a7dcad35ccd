"""Hints that sharded code reads when its caller passes none: the
reference's eight, set together by :func:`activation_specs`.

* ``ACT_SPEC``: the residual stream's (B, S, d) spec.  Set (by
  ``launch.steps.make_train_step(mesh=)`` and the serving steps
  ``make_prefill_step`` / ``make_serve_step``), the model runs on this
  rank's local tensors: heads, ``d_ff`` and the vocabulary split over
  "model" (``parallel.collectives``' tensor-parallel helpers, read by
  ``models.layers``, ``models.model`` and ``models.moe``).  With its
  sequence entry on "model" (``P(dp, "model", None)``) the stream between
  blocks is the rank's (B_loc, S/tp, d) block; with ``P(dp, None, None)``
  it is (B_loc, S, d).  Unset, everything runs on whole tensors.
* ``LOGIT_SPEC``: the logits' spec; set (``P(dp, None, "model")``),
  ``model.loss_fn`` takes the vocab-parallel cross-entropy.
* ``MOE_SPEC`` / ``MOE_COMBINE_SPEC``: the dispatched expert tiles' and
  the combined tiles' specs, set as the reference sets them.  Under a
  ``MESH`` ``MOE_SPEC`` selects ``models.moe.apply_moe``'s pjit layer on
  this rank's experts and rows (the serving steps), its first entry the
  experts' axis; that layer combines in ``MOE_COMBINE_SPEC``'s
  row-sharded layout and refuses one that splits the slots or d.
* ``MESH``: a ``torch.distributed.device_mesh.DeviceMesh`` (or ``None``);
  ``kernels.engine.auto_mesh``, ``models.layers.sharded_flash_attention``
  (without ``ACT_SPEC``), ``models.moe.apply_moe``'s mesh branches and
  the tensor-parallel helpers read it.
* ``MOE_IMPL``: ``"pjit"`` (the one-device layer, the default) or
  ``"shard_map"`` (with a ``MESH``: ``models.moe_shard_map``, the
  train-only expert-parallel layer).
* ``MOE_DISPATCH``: ``"gather"`` | ``"bcsr"`` | ``None`` (the config's
  ``moe_dispatch``), read by ``models.moe`` where no ``dispatch=`` is
  given.
* ``MOE_GROUPS``: the dispatch row groups the data axes expect; routing is
  per batch row, so ``models.moe`` only checks that it divides the batch
  (the global batch under a mesh).

:func:`activation_specs` sets all eight for a scope and restores the
previous values after, also when the block raises, as the reference's
does.  The specs are ``parallel.sharding.PartitionSpec``s.
"""
from __future__ import annotations

import contextlib
from typing import Optional

ACT_SPEC = None                       # residual stream (B, S, d)
MOE_SPEC = None                       # dispatched expert tiles (E, B, C, d)
LOGIT_SPEC = None                     # logits (B, S, V)
MOE_GROUPS: Optional[int] = None
MOE_COMBINE_SPEC = None               # post-expert tiles (B, E*C, d)
MOE_IMPL: str = "pjit"                # "pjit" | "shard_map"
MOE_DISPATCH: Optional[str] = None    # "gather" | "bcsr" | None (= cfg field)
MESH = None


@contextlib.contextmanager
def activation_specs(act=None, moe=None, logit=None,
                     moe_groups: Optional[int] = None, moe_combine=None,
                     moe_impl: str = "pjit",
                     moe_dispatch: Optional[str] = None, mesh=None):
    """The eight hints set inside the ``with`` block, the previous values
    after (also when the block raises)."""
    global ACT_SPEC, MOE_SPEC, LOGIT_SPEC, MOE_GROUPS, MOE_COMBINE_SPEC, \
        MOE_IMPL, MOE_DISPATCH, MESH
    prev = (ACT_SPEC, MOE_SPEC, LOGIT_SPEC, MOE_GROUPS, MOE_COMBINE_SPEC,
            MOE_IMPL, MOE_DISPATCH, MESH)
    (ACT_SPEC, MOE_SPEC, LOGIT_SPEC, MOE_GROUPS, MOE_COMBINE_SPEC, MOE_IMPL,
     MOE_DISPATCH, MESH) = (act, moe, logit, moe_groups, moe_combine,
                            moe_impl, moe_dispatch, mesh)
    try:
        yield
    finally:
        (ACT_SPEC, MOE_SPEC, LOGIT_SPEC, MOE_GROUPS, MOE_COMBINE_SPEC,
         MOE_IMPL, MOE_DISPATCH, MESH) = prev
