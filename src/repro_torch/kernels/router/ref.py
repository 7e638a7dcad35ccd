"""Plain PyTorch version of the router kernel R1 (``csrc/router.cu``).

``router_logits_ref`` is the reference's router product,
``x.astype(f32) @ router.astype(f32)`` (repro/models/moe.py:232): the CPU
path of ``moe.route_tokens``, and what ``chip_smoke.py`` holds the kernel
against on the card.  Its summation order is the library's, which may
depend on the number of rows; the kernel's is fixed (see its source).
"""
from __future__ import annotations

import torch


def router_logits_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (..., d); w: (d, E).  Returns (..., E) f32 logits."""
    return x.float() @ w.float()


def router_logits_ordered(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's summation order in PyTorch: lane ``l`` of 32 sums
    ``f32(x[t, d]) * f32(W[d, e])`` over d = l, l + 32, ... in that order
    (each product and each sum rounded to f32), then the lanes are added by
    the xor-butterfly 16, 8, 4, 2, 1.  Elementwise ops only, so a token's
    logits are the same bits whatever else is in ``x``; on the card the
    kernel gives these bits (``chip_smoke.py``)."""
    d, E = w.shape
    xt = x.reshape(-1, d).float()
    wf = w.float()
    pad = (-d) % 32
    xt = torch.nn.functional.pad(xt, (0, pad))          # zero terms: exact
    wf = torch.nn.functional.pad(wf, (0, 0, 0, pad))
    xs = xt.reshape(xt.shape[0], -1, 32)                 # (T, steps, lane)
    ws = wf.reshape(-1, 32, E)                           # (steps, lane, E)
    acc = torch.zeros((xt.shape[0], 32, E), dtype=torch.float32,
                      device=x.device)
    for i in range(xs.shape[1]):
        acc = acc + xs[:, i, :, None] * ws[i]
    lanes = torch.arange(32, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lanes ^ o]
    return acc[:, 0].reshape(*x.shape[:-1], E)
