"""PyTorch + CUDA port of the ``repro`` package (JAX + Pallas), for NVIDIA Hopper.

The sub-paths mirror the JAX package (``models/moe.py`` <-> ``models/moe.py``
and so on) so each module's counterpart is easy to find.  The port imports
torch and numpy only; the JAX package stays the reference that the tests hold
the port against.

Numerics are set once, here: the reference multiplies bf16 operands with f32
accumulation (``preferred_element_type``) and f32 operands in full f32, so
TF32 and bf16 split-K reductions, either of which would change logits and
break the exact dispatch copy, are switched off for the whole process.
"""
from __future__ import annotations

import torch


def set_numerics() -> None:
    """Full-precision matmul numerics (no TF32, no reduced-precision bf16
    reduction), as the reference computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


set_numerics()


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Entry points default to
    ``"cuda"``; without a GPU that raises, so a CPU run must be asked for
    with ``device="cpu"`` (as the tests do) and never happens by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
