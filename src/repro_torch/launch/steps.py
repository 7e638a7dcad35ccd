"""Step factories of training (``repro/launch/steps.py``), on one device.

:func:`make_train_step` returns ``train_step(params, opt_state, tokens,
embeddings=None) -> (params, opt_state, {"loss", "grad_norm"})``: the
value and gradient of ``model.loss_fn`` (remat a superblock, the
cross-entropy ``seq_chunk`` positions at a time), optionally over
``microbatches`` slices of the batch whose f32 gradients are summed and
divided by their number, as the reference's scan, then the optimizer's
update.  Numpy inputs go to the params' device.  The reference's partition
specs, ``make_prefill_step`` and ``make_serve_step`` belong with the
port's multi-card path and are not here; a ``mesh`` is refused.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch import as_tensor, tree
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm


def default_optimizer(total_steps: int = 10000,
                      master_weights: bool = False) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, 200, total_steps),
                 master_weights=master_weights)


def cast_params_bf16(params):
    """Model params in bf16 (f32 leaves of two or more dims); norm scales
    and bias vectors stay f32."""
    return tree.map(lambda x: x.to(torch.bfloat16)
                    if x.dim() >= 2 and x.dtype == torch.float32 else x,
                    params)


def value_and_grad(loss_of: Callable, params) -> Tuple[torch.Tensor, object]:
    """(loss, the gradient tree of ``loss_of(params)``), as
    ``jax.value_and_grad``: each leaf's gradient in its own dtype, zeros
    where the loss does not reach it."""
    leaves = tree.leaves(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    loss = loss_of(tree.unflatten(params, req))
    grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def inputs_on(params, tokens, embeddings=None):
    """``tokens`` and ``embeddings`` (numpy or tensors) on the params'
    device."""
    dev = tree.leaves(params)[0].device
    tokens = as_tensor(tokens, dev)
    return tokens, None if embeddings is None else as_tensor(embeddings, dev)


def make_train_step(cfg: ArchConfig, shape: ShapeSpec,
                    optimizer: Optional[AdamW] = None, *,
                    seq_chunk: int = 512, impl: str = "chunked",
                    microbatches: Optional[int] = None,
                    attn_impl: Optional[str] = None, mesh=None) -> Callable:
    """The train step of ``cfg`` at ``shape`` (its ``microbatches`` unless
    given) on the params' device; ``attn_impl`` (default ``impl``) is the
    attention's ("chunked", or "kernel_sharded": K3 forward, chunked
    backward)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the sharded train step (partition "
            "specs, shard_map) waits for the multi-card path (ROADMAP Queue "
            "1 item 4); this step runs on one device")
    optimizer = optimizer or default_optimizer()
    k = microbatches or shape.microbatches
    impl = attn_impl or impl

    def loss_of(tokens, embeddings):
        return lambda p: M.loss_fn(p, tokens, cfg, embeddings=embeddings,
                                   impl=impl, seq_chunk=seq_chunk)

    def train_step(params, opt_state, tokens, embeddings=None):
        tokens, embeddings = inputs_on(params, tokens, embeddings)
        if k == 1:
            loss, grads = value_and_grad(loss_of(tokens, embeddings), params)
        else:
            B = tokens.shape[0]
            if B % k:
                raise ValueError(f"train_step: batch {B} does not split "
                                 f"into {k} microbatches")
            mb = B // k
            loss = torch.zeros((), device=tokens.device)
            grads = tree.map(lambda p: torch.zeros(p.shape, device=p.device),
                             params)
            for i in range(k):
                rows = slice(i * mb, (i + 1) * mb)
                l, g = value_and_grad(loss_of(
                    tokens[rows],
                    None if embeddings is None else embeddings[rows]),
                    params)
                tree.map(lambda acc, gi: acc.add_(gi), grads, g)
                loss = loss + l
            loss = loss / k
            grads = tree.map(lambda g: g / k, grads)
        gn = global_norm(grads)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "grad_norm": gn}

    return train_step
