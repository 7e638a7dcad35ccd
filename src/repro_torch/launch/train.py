"""Training launcher: the fault-tolerant trainer over a config of the
registry (``repro/launch/train.py``), on the card unless ``--device cpu``.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --smoke --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch llama4-scout-17b-a16e --smoke --steps 20 \
      --grad-compress-k 4096
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device, tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.su import stream_densify
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.grad_comp.sparse_allreduce import compress
from repro_torch.launch.steps import inputs_on, value_and_grad
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.runtime.trainer import Trainer, TrainerConfig


def make_step(cfg, opt: AdamW, grad_compress_k: int = 0):
    """``step(params, opt_state, tokens, embeddings=None)``: the loss and
    gradient of ``model.loss_fn``; with ``grad_compress_k`` every leaf
    larger than k keeps only its top-k entries (the sparse exchange's
    compress and densify on one process, the lossy path end to end); then
    the optimizer's update."""
    def comp(g):
        if g.numel() <= grad_compress_k:
            return g
        keys, vals, _ = compress(g.reshape(-1), grad_compress_k)
        count = torch.tensor(grad_compress_k, device=g.device)
        return stream_densify(keys, vals, count, g.numel()).reshape(g.shape)

    def step(params, opt_state, tokens, embeddings=None):
        tokens, embeddings = inputs_on(params, tokens, embeddings)
        loss, grads = value_and_grad(
            lambda p: M.loss_fn(p, tokens, cfg, embeddings=embeddings),
            params)
        if grad_compress_k:
            grads = tree.map(comp, grads)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss, "grad_norm": global_norm(grads)}
    return step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--grad-compress-k", type=int, default=0)
    ap.add_argument("--policy", default=None, help="f32|bf16|fp8_e4m3")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.policy:
        cfg = dataclasses.replace(cfg, policy=args.policy)
    opt = AdamW(lr=cosine_schedule(args.lr, warmup=min(20, args.steps // 5),
                                   total=args.steps))
    data = SyntheticLM(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=5),
        cfg, make_step(cfg, opt, args.grad_compress_k), opt, data,
        init_state=lambda: M.init_params(cfg, seed=0, device=device,
                                         param_dtype=torch.float32))
    out = trainer.run()
    first = out["history"][0][1] if out["history"] else float("nan")
    last = out["history"][-1][1] if out["history"] else float("nan")
    print(f"done on {device}: loss {first:.4f} -> {last:.4f} over "
          f"{args.steps} steps; stragglers={len(out['stragglers'])}")


if __name__ == "__main__":
    main()
