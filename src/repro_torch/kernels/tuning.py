"""Tile table for the port's kernels, keyed by (op, dtype bucket, platform).

The ``cpu`` rows are the reference's CPU rows (``repro/kernels/tuning.py``):
on the CPU the port runs the plain PyTorch versions, and the MoE dispatch
geometry (``block``, ``min_bucket``) must equal the reference's so the routed
stream matches it entry for entry.  The ``cuda`` rows are this port's own
choice for the Hopper kernels, not carried over from the TPU rows:

* ``block`` (8, 8): the 0/1 (slot, token) dispatch matrix has one nonzero per
  token column, so small square blocks keep the routed stream sparse.
* ``bn`` 256: the N-tile of one SpMM thread block, one output column per
  thread (256 threads).
* ``min_bucket`` 8: the port compiles nothing per stream shape, so the nnzb
  bucket floor only bounds zero-block work on one-token decode streams.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

_TABLE: Dict[Tuple[str, str, str], Dict[str, Any]] = {
    ("spmm", "f32", "cpu"): {"bn": 128},
    ("spmm", "bf16", "cpu"): {"bn": 128},
    ("spmm", "f32", "cuda"): {"bn": 256},
    ("spmm", "bf16", "cuda"): {"bn": 256},
    ("moe_dispatch", "f32", "cpu"): {"block": (8, 8), "bn": 128,
                                     "min_bucket": 8},
    ("moe_dispatch", "bf16", "cpu"): {"block": (8, 8), "bn": 128,
                                      "min_bucket": 8},
    ("moe_dispatch", "f32", "cuda"): {"block": (8, 8), "bn": 256,
                                      "min_bucket": 8},
    ("moe_dispatch", "bf16", "cuda"): {"block": (8, 8), "bn": 256,
                                       "min_bucket": 8},
}


def _bucket(dtype: torch.dtype) -> str:
    return "f32" if dtype.itemsize >= 4 else "bf16"


def _row(op: str, dtype: torch.dtype, device) -> Dict[str, Any]:
    plat = torch.device(device).type
    return dict(_TABLE[(op, _bucket(dtype), plat)])


def spmm_bn(dtype=torch.float32, device="cpu") -> int:
    """N-tile (threads per block) of the BCSR SpMM kernel."""
    return int(_row("spmm", dtype, device)["bn"])


def moe_dispatch_tiles(d_model: int, dtype=torch.float32,
                       device="cpu") -> Dict[str, Any]:
    """{"block": (bm, bk), "bn": int, "min_bucket": int} for the MoE
    dispatch-as-SpMM path; ``min_bucket`` is the floor of the power-of-two
    nnzb bucket the routed stream is padded to (``engine.stream_bucket``).
    ``bn`` is never wider than ``d_model`` rounded up to a warp."""
    row = _row("moe_dispatch", dtype, device)
    bm, bk = row["block"]
    bn = min(int(row["bn"]), max(32, -(-d_model // 32) * 32))
    return {"block": (int(bm), int(bk)), "bn": bn,
            "min_bucket": int(row["min_bucket"])}
