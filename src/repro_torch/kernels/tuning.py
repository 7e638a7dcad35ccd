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
* ``flash`` (bq, bk) 64 x 64, for K3 and the masked kernels K4m / K4s
  alike: the flash kernels (``flash_attention/csrc/flash_attention.cu``)
  stage a Q, K and V tile and the score tile in f32 shared memory, 115 KB at
  D = 128, and take tiles of at most 64 x 64.  At S = 2048 a 64-wide tile
  also resolves a local window finer than a 128-wide one (275 of 528 causal
  tiles visible under a local window of 512 plus one global tile, against
  81 of 136).

The ``cpu`` flash rows keep the reference's 128 x 128 (its ``flash`` and
``flash_sparse`` CPU rows are equal) and its sublane / VMEM clamp, so that
CPU tiles, and with them every tile-granular mask, equal the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# The reference's CPU clamp (``repro/kernels/tuning.py``): sequences round
# up to the 8-row sublane, and a K/V tile halves while its working set would
# exceed the VMEM budget.
SUBLANE = 8
LANE = 128
VMEM_BUDGET = 8 * 2**20
# Shared memory one CUDA thread block may use on Hopper (227 KB).
SMEM_BUDGET = 232448
# Largest (bq, bk) tile the flash kernels take.
FLASH_MAX_TILE = 64

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
    ("flash", "f32", "cpu"): {"bq": 128, "bk": 128},
    ("flash", "bf16", "cpu"): {"bq": 128, "bk": 128},
    ("flash", "f32", "cuda"): {"bq": 64, "bk": 64},
    ("flash", "bf16", "cuda"): {"bq": 64, "bk": 64},
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


def flash_smem_bytes(bq: int, bk: int, d: int) -> int:
    """Shared memory of one flash thread block: f32 Q and K tiles with rows
    padded by one word, the V tile, and the padded (bq, bk) score tile."""
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1))


def _flash_clamp(bq: int, bk: int, sq: int, skv: int, d: int,
                 dtype: torch.dtype, device) -> Tuple[int, int]:
    """No longer than the sublane-aligned sequences; then the platform's
    memory clamp: the reference's VMEM budget on the CPU, the block's shared
    memory on the card."""
    bq = min(bq, -(-max(sq, 1) // SUBLANE) * SUBLANE)
    bk = min(bk, -(-max(skv, 1) // SUBLANE) * SUBLANE)
    if torch.device(device).type == "cpu":
        eb = dtype.itemsize
        while bk > LANE and (4 * bk * d * eb + bq * d * 4
                             + 2 * bq * d * eb) > VMEM_BUDGET:
            bk //= 2
    else:
        while bk > SUBLANE and flash_smem_bytes(bq, bk, d) > SMEM_BUDGET:
            bk //= 2
    return bq, bk


def flash_tiles(sq: int, skv: int, d: int, dtype=torch.float32,
                device="cpu") -> Tuple[int, int]:
    """(bq, bk) tile lengths of the flash-attention kernels (K3, and the
    masked K4m / K4s where a mask spec gives no tiles); ``ops`` applies its
    divisibility-aware re-clamp on top of K3's."""
    row = _row("flash", dtype, device)
    return _flash_clamp(int(row["bq"]), int(row["bk"]), sq, skv, d, dtype,
                        device)

