"""PyTorch + CUDA port of the ``repro`` package (JAX + Pallas), for NVIDIA Hopper.

The sub-paths mirror the JAX package (``models/moe.py`` <-> ``models/moe.py``
and so on) so each module's counterpart is easy to find.  The port imports
torch and numpy only; the JAX package stays the reference that the tests hold
the port against.

Numerics are set once, here: the reference multiplies bf16 operands with f32
accumulation (``preferred_element_type``) and f32 operands in full f32, so
TF32 and bf16 split-K reductions, either of which would change logits and
break the exact dispatch copy, are switched off for the whole process.

The entry points' helpers live here too: :func:`resolve_device` (the card
unless the caller asks for the CPU) and :func:`as_tensor` (numpy input goes
to that device; a tensor stays where it lies).
"""
from __future__ import annotations

from typing import Any

import numpy as np
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
    with ``device="cpu"`` (as the tests do) and never happens by itself.
    ``"meta"`` (shapes and dtypes only) is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available()"
            " is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev


# ml_dtypes names -> (the view that crosses, the torch dtype it becomes)
_BYTE_VIEWS = {"bfloat16": (np.uint16, torch.bfloat16),
               "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
               "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def to_tensor(a: Any) -> torch.Tensor:
    """A numpy (or array-like) array as a CPU tensor; bf16 and fp8 (the
    ``ml_dtypes`` types, which ``torch.from_numpy`` refuses) through their
    bytes."""
    a = np.array(a)                     # a writable copy
    if a.dtype.name in _BYTE_VIEWS:
        view, dtype = _BYTE_VIEWS[a.dtype.name]
        return torch.from_numpy(a.view(view)).view(dtype)
    return torch.from_numpy(a)


def as_tensor(x, device=None) -> torch.Tensor:
    """An entry point's array argument: a tensor stays where it lies (or
    moves to ``device`` if one is given); a numpy array goes to ``device``,
    the card by default."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return to_tensor(x).to(resolve_device(device or "cuda"))
