"""Param interop with the reference: a JAX param tree (fetched to numpy)
becomes the port's param tree on a device.

The layout is the same on both sides -- nested dicts, slot params stacked on
a leading ``n_repeats`` dim -- so the conversion is leaf by leaf.  A bf16
array (an ``ml_dtypes`` dtype, which ``torch.from_numpy`` refuses) crosses as
a ``uint16`` view of its bytes.  Matmul weights are stored in the policy's
compute dtype: the reference casts f32 weights to it at every use, which is
the same round-to-nearest-even.  Norm scales and routers stay f32: routing
multiplies in f32.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.precision import policy as precision_policy
from repro_torch.models.config import ArchConfig

_F32_LEAVES = ("scale", "router")


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or array-like) leaf as a CPU tensor, bf16 through its bytes."""
    a = np.array(a)                     # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree, cfg: ArchConfig, *, device="cuda"):
    """Convert a reference param tree (leaves numpy or array-like) into the
    port's params on ``device``."""
    dev = resolve_device(device)
    cd = precision_policy(cfg.policy).compute_dtype

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return tuple(conv(v, key) for v in node)
        t = to_tensor(node)
        dtype = torch.float32 if key in _F32_LEAVES else cd
        return t.to(device=dev, dtype=dtype)

    return conv(tree)
