"""Shared benchmark utilities of the port: timing, CSV rows and the JSON
artifact, the counterpart of the reference's ``benchmarks/common.py``.

Times come from the device the benchmark ran on: on the card the host clock
around work that ends in ``torch.cuda.synchronize``, on the CPU the host
clock alone.  A CPU time says how fast PyTorch's CPU kernels are, never how
fast the card is; every artifact names its device (:func:`emit_bench`).
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time
from typing import Any, Callable, Dict, Optional

import torch

# the checkout's build/ (git-ignored): the reference's BENCH_*.json files in
# benchmarks/ are its own artifacts and are never written here
BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))), "build", "bench")


def time_fn(fn: Callable, *args, device="cuda", warmup: int = 2,
            iters: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` over ``iters`` calls after
    ``warmup`` calls.  On the card each call ends in
    ``torch.cuda.synchronize`` inside the timed region (the call's device
    work and its host launches); on the CPU ``time.perf_counter`` alone."""
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"


def card() -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _coerce(v):
    """JSON-ready: dict keys as strings, tuples as lists, numpy and torch
    scalars as Python numbers (anything else with ``item`` as its string)."""
    if isinstance(v, dict):
        return {str(k): _coerce(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_coerce(x) for x in v]
    if hasattr(v, "item") and not isinstance(v, (str, bytes)):
        try:
            return v.item()
        except (ValueError, RuntimeError, TypeError):
            return str(v)
    return v


def emit_bench(name: str, payload: Dict[str, Any], *, device=None,
               directory: Optional[str] = None) -> str:
    """Write ``BENCH_torch_<name>.json``, the benchmark's machine-readable
    artifact, into ``directory`` (default ``build/bench/`` of the
    checkout); returns its path.  ``payload`` is the benchmark's own
    schema; this adds the header every artifact shares: ``backend`` (the
    type of ``device``, default the card when there is one), its
    ``device_count``, ``torch_version``, ``platform`` and, on the card,
    ``card``: its name and power limit (:func:`card`)."""
    dev = torch.device(device if device is not None else
                       ("cuda" if torch.cuda.is_available() else "cpu"))
    doc = {"bench": name, "backend": dev.type,
           "device_count": (torch.cuda.device_count() if dev.type == "cuda"
                            else 1),
           "torch_version": torch.__version__,
           "platform": platform.platform()}
    if dev.type == "cuda":
        doc["card"] = card()
    doc.update(_coerce(payload))
    directory = directory or BENCH_DIR
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"BENCH_torch_{name}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=False)
        f.write("\n")
    return path
