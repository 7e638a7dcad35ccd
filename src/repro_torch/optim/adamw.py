"""AdamW, the cosine schedule and clipping, as functions over param trees.

The port of ``repro/optim/adamw.py``.  The state mirrors the params
(``AdamWState``: the moments ``m`` and ``v``, the step ``count``, and the
f32 ``master`` copy when the params live in bf16), so it is the
reference's tree leaf for leaf and a checkpoint of either package restores
into the other.  There is no ``torch.optim``: :meth:`AdamW.update` is a
function of (grads, state, params) that returns new params and a new state
and leaves its inputs as they are.  It runs in f32 under
``torch.no_grad()``, with the reference's arithmetic: clipping by the
global norm plus 1e-9, bias corrections ``1 - b ** count`` in f32, weight
decay on leaves of two or more dims only, and JAX's types where the
gradients are bf16 (clipped gradients become f32; a Python scalar times a
bf16 gradient is a bf16 product).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor          # () int32
    master: Any = None           # f32 copy of bf16 params, or None


def _weak(c: float, t: torch.Tensor) -> float:
    """The Python scalar ``c`` as a product with ``t`` sees it in JAX, a
    weakly typed scalar cast to ``t``'s dtype: rounded to bf16 for a bf16
    ``t`` (torch would multiply by it in f32), as it is otherwise."""
    return _bf16(c) if t.dtype == torch.bfloat16 else c


@functools.lru_cache(maxsize=None)
def _bf16(c: float) -> float:
    return float(torch.tensor(c, dtype=torch.bfloat16))


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a () tensor)."""
    total = sum(torch.sum(torch.square(g.float())) for g in tree.leaves(grads))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
    """lr(count): linear warmup to ``peak_lr`` over ``warmup`` steps, then
    a cosine down to ``floor * peak_lr`` at ``total``; in f32."""
    def lr(count: torch.Tensor) -> torch.Tensor:
        c = count.float()
        warm = peak_lr * c / max(warmup, 1)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(c < warmup, warm, cos)
    return lr


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0
    # bf16 model params with the f32 master copy in the state
    master_weights: bool = False

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
        master = (tree.map(lambda p: p.float().clone(), params)
                  if self.master_weights else None)
        some = tree.leaves(params)[0]
        return AdamWState(m=tree.map(zeros, params),
                          v=tree.map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32,
                                            device=some.device),
                          master=master)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """(new params in their own dtypes, new state)."""
        count = state.count + 1
        if self.clip_norm is not None:
            gn = global_norm(grads)
            scale = torch.clamp(self.clip_norm / (gn + 1e-9), max=1.0)
            # an f32 array times a bf16 one is f32 in JAX
            grads = tree.map(lambda g: g.float() * scale, grads)
        b1, b2 = self.b1, self.b2
        m = tree.map(lambda mm, g: b1 * mm + _weak(1 - b1, g) * g, state.m,
                     grads)
        v = tree.map(lambda vv, g: b2 * vv + _weak(1 - b2, g) * g * g,
                     state.v, grads)
        c = count.float()
        bc1 = 1 - b1 ** c
        bc2 = 1 - b2 ** c
        lr = self.lr(count) if callable(self.lr) else self.lr

        def upd(p, mm, vv):
            step = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            p32 = p.float()
            if p.dim() >= 2:
                step = step + self.weight_decay * p32
            return p32 - lr * step

        base = state.master if state.master is not None else params
        new_master = tree.map(upd, base, m, v)
        new_params = tree.map(lambda nm, p: nm.to(p.dtype), new_master,
                              params)
        master_out = new_master if state.master is not None else None
        return new_params, AdamWState(m=m, v=v, count=count,
                                      master=master_out)
