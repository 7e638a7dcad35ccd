"""Row reductions through the router kernel R1.

``row_sum`` is the sum over the last axis in one order a row on the card:
R1 (``kernel.router_logits``) of x by a (d, 1) column of ones, whose
products are exact, so the sum is R1's order (``ref.router_logits_ordered``:
lane stride 32, then the xor butterfly) and a row sums to the same bits in
any batch.  The decode step's norms take their sum of squares from it
(``models.layers.rmsnorm(row_order=True)``).  A CPU tensor takes the
library's sum.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.router import kernel as _kernel


@functools.lru_cache(maxsize=None)
def _ones_column(d: int, device: torch.device) -> torch.Tensor:
    return torch.ones((d, 1), device=device)


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., d) f32 or bf16.  Returns (..., 1) f32: the sum over the last
    axis, on the card through R1 (counted in ``router_logits.launches``), on
    the CPU ``x.float().sum(-1, keepdim=True)``."""
    if x.device.type == "cpu":
        return x.float().sum(-1, keepdim=True)
    return _kernel.router_logits(x, _ones_column(x.shape[-1], x.device))
