"""Interop with the reference: a JAX param tree (fetched to numpy) becomes
the port's param tree on a device, and the reference's sparse and quantized
containers become the port's.

The layout is the same on both sides -- nested dicts, slot params stacked on
a leading ``n_repeats`` dim -- so the conversion is leaf by leaf.  A bf16
array (an ``ml_dtypes`` dtype, which ``torch.from_numpy`` refuses) crosses as
a ``uint16`` view of its bytes, an fp8 array (``float8_e4m3fn`` /
``float8_e5m2``) as a ``uint8`` view.  Matmul weights are stored in the
policy's compute dtype: the reference casts f32 weights to it at every use,
which is the same round-to-nearest-even.  Norm scales and routers stay f32:
routing multiplies in f32.  So do the RWKV decay LoRA, ``decay_base`` and
``bonus_u``, and the Mamba-2 ``a_log``, ``d_skip`` and ``dt_bias``, which
the reference uses in f32; the RWKV lerp factors ``mu`` / ``mu_c`` and the
Mamba-2 conv's ``conv_w`` / ``conv_b`` are cast at use like the weights.
Training keeps every leaf's own dtype (``params_from_jax(train=True)``),
and an optimizer state crosses as it is (:func:`opt_state_from_jax`).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import as_tensor, resolve_device, to_tensor  # noqa: F401
from repro_torch.core.formats import BCSR, BatchedBCSR
from repro_torch.core.precision import QuantTensor
from repro_torch.core.precision import policy as precision_policy
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamWState

F32_LEAVES = ("scale", "router", "decay_base", "decay_lora_a",
               "decay_lora_b", "bonus_u", "a_log", "d_skip", "dt_bias")


def bcsr_from_jax(a, *, device="cuda") -> Union[BCSR, BatchedBCSR]:
    """A reference ``BCSR`` / ``BatchedBCSR`` (scales included) as the
    port's container on ``device``."""
    dev = resolve_device(device)
    kw = {f: to_tensor(getattr(a, f)).to(dev)
          for f in ("indptr", "block_rows", "block_cols", "blocks")}
    scales = None if a.scales is None else to_tensor(a.scales).to(dev)
    cls = BatchedBCSR if len(a.shape) == 3 else BCSR
    return cls(shape=tuple(a.shape), block=tuple(a.block), scales=scales,
               **kw)


def quant_tensor_from_jax(t, *, device="cuda") -> QuantTensor:
    """A reference ``QuantTensor`` as the port's on ``device``."""
    dev = resolve_device(device)
    return QuantTensor(values=to_tensor(t.values).to(dev),
                       scales=to_tensor(t.scales).to(dev), axis=t.axis)


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda",
                    train: bool = False):
    """Convert a reference param tree (leaves numpy or array-like) into the
    port's params on ``device``: serving's dtypes (module docstring), or
    with ``train`` each leaf in its own dtype, as the reference trains on
    it (f32 from its ``init_params``, bf16 after ``cast_params_bf16``)."""
    dev = resolve_device(device)
    cd = precision_policy(cfg.policy).compute_dtype

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v, key) for v in node)
        t = to_tensor(node)
        if train:
            return t.to(dev)
        dtype = torch.float32 if key in F32_LEAVES else cd
        return t.to(device=dev, dtype=dtype)

    return conv(tree)


def opt_state_from_jax(state, *, device="cuda") -> AdamWState:
    """A reference ``AdamWState`` (leaves numpy or array-like) as the
    port's on ``device``, each leaf in its own dtype: both packages then
    step from the same state."""
    dev = resolve_device(device)

    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v) for v in node)
        return to_tensor(node).to(dev)

    return AdamWState(m=conv(state.m), v=conv(state.v),
                      count=conv(state.count), master=conv(state.master))
