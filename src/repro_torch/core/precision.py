"""Precision policy: named (param, compute, accum) dtype triples.

The port of ``policy()`` from the reference ``core/precision.py``; the
BlockQuant helpers of that module are not ported yet.  Matmuls take their
operands in the compute dtype and accumulate in the accum dtype (f32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

LADDER: Dict[str, torch.dtype] = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """param/compute/accum dtype triple with widening accumulation."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32


def policy(name: str = "bf16") -> PrecisionPolicy:
    """Named policies for the ladder; ``name`` is the compute dtype."""
    return PrecisionPolicy(param_dtype=torch.float32,
                           compute_dtype=LADDER[name],
                           accum_dtype=torch.float32)
