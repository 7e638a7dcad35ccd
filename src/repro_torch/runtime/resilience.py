"""Serving resilience: deterministic fault injection, retry and shed
policy, health tracking and the degradation ladder.  The port of
``repro/runtime/resilience.py``.

Every failure path of the serving drivers (``launch.serve``) can be
injected deterministically, so it can be tested and reproduced bit for
bit, and is survived per request, so a poisoned row never takes down the
rows batched with it.

* :class:`FaultSpec` / :class:`FaultPlan`: faults keyed by stage
  (``prefill / route / execute / attention / sample / quantize``).  A NaN
  or Inf poison is one ``torch.where`` on a row mask uploaded without
  blocking the host (:func:`poison_rows`), so an injection makes no host
  sync; a host fault raises :class:`InjectedFault`; a straggler sleeps.
  ``plan.triggered`` logs every firing.
* :class:`RetryPolicy`: bounded exponential backoff.
* :class:`HealthTracker`: counters and a bounded event log.
* :class:`DegradationLadder`: the rungs ``kv_wide`` -> ``mask_ref`` ->
  ``pipeline_serial`` a driver walks as failures accumulate.
* :func:`corrupt_quant_scales` (the ``quantize`` fault) and
  :func:`dequantize_cache` (the ``kv_wide`` rung).

The port writes its caches in place (a captured decode graph binds their
storage), so :func:`corrupt_quant_scales` poisons the leaves in place,
where the reference returns new arrays; :func:`dequantize_cache` makes a
new tree, as the reference's does.
"""
from __future__ import annotations

import dataclasses
import random as _random
import time
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import precision
from repro_torch.models import moe

STAGES: Tuple[str, ...] = (
    "prefill", "route", "execute", "attention", "sample", "quantize")

# activation stages take nan / inf poisons and the host-side exception /
# straggler; the quantize stage corrupts cache scale leaves
KINDS: Tuple[str, ...] = ("nan", "inf", "exception", "straggler")

_QUANT_LEAVES = frozenset({"k", "k_scale", "v", "v_scale"})
_FILL = {"nan": float("nan"), "inf": float("inf")}


class InjectedFault(RuntimeError):
    """Raised by a FaultPlan ``exception`` fault (host-side failure)."""


class ShedError(RuntimeError):
    """Raised when admission control rejects a request (queue full)."""


def _row_mask(rows: Sequence[int], n: int, device) -> torch.Tensor:
    """A (n,) bool mask of ``rows``, uploaded without blocking the host."""
    mask = np.zeros(n, bool)
    mask[list(rows)] = True
    return moe._upload(mask, device)


def poison_rows(x: torch.Tensor, rows: Sequence[int],
                kind: str) -> torch.Tensor:
    """``x`` with its batch rows ``rows`` (dim 0) NaN or Inf, the others
    as they were: one ``torch.where`` on a (B,) row mask broadcast over the
    trailing dims.  Nothing here syncs with the host."""
    if not rows:
        return x
    mask = _row_mask(rows, x.shape[0], x.device)
    return torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)),
                       _FILL[kind], x)


def _poison_axis1(x: torch.Tensor, rows: Sequence[int], kind: str) -> None:
    if x.dim() < 2 or not x.is_floating_point():
        return
    idx = moe._upload(np.asarray(list(rows), np.int64), x.device)
    x.index_fill_(1, idx, _FILL[kind])


def corrupt_quant_scales(cache: Any, rows: Sequence[int], kind: str) -> Any:
    """Poison rows ``rows`` (batch axis 1: leaves are ``(layers, B, ...)``)
    of a quantized KV cache's ``k_scale`` / ``v_scale`` leaves, **in
    place**; a cache without scales gets its wide ``k`` / ``v`` poisoned
    instead, so the fault shows under every cache configuration.  Other
    leaves (MoE occupancy, RWKV state) are untouched.  Returns ``cache``."""
    if not rows:
        return cache

    def walk(node):
        if isinstance(node, dict):
            keys = set(node)
            if keys & {"k_scale", "v_scale"}:
                names = ("k_scale", "v_scale")
            elif keys & {"k", "v"} and keys <= _QUANT_LEAVES | {"occupancy"}:
                names = ("k", "v")
            else:
                for v in node.values():
                    walk(v)
                return
            for name in names:
                if name in node:
                    _poison_axis1(node[name], rows, kind)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(cache)
    return cache


def dequantize_cache(cache: Any, dtype: torch.dtype = torch.float32) -> Any:
    """A quantized KV cache rewritten wide, as a new tree: every ``{k,
    k_scale, v, v_scale}`` dict collapses to ``{k, v}`` dequantized to
    ``dtype`` (``precision.dequantize_rows``, the reference's arithmetic);
    every other leaf (MoE occupancy, RWKV state) is passed through as the
    same tensor.  The ``kv_wide`` rung."""

    def walk(node):
        if isinstance(node, dict):
            if {"k", "k_scale", "v", "v_scale"} <= set(node):
                out = {k: v for k, v in node.items()
                       if k not in _QUANT_LEAVES}
                out["k"] = precision.dequantize_rows(
                    node["k"], node["k_scale"], dtype)
                out["v"] = precision.dequantize_rows(
                    node["v"], node["v_scale"], dtype)
                return out
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(cache)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: fires at ``stage`` when every selector that
    is not None matches (``uid`` the request, ``row`` the batch row,
    ``step`` the decode step, ``layer`` the index of the hook's call within
    one (stage, step)), at most ``times`` times in all."""

    stage: str
    kind: str
    uid: Optional[int] = None
    row: Optional[int] = None
    step: Optional[int] = None
    layer: Optional[int] = None
    times: int = 1
    delay_s: float = 0.05

    def __post_init__(self):
        if self.stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}, got {self.stage!r}")
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.stage == "quantize" and self.kind in ("exception", "straggler"):
            raise ValueError("quantize faults corrupt scales: kind must be "
                             "'nan' or 'inf'")


class FaultPlan:
    """A deterministic registry of :class:`FaultSpec` s.

    The drivers call :meth:`apply` at each stage boundary with the
    activation and its context; the plan returns the activation as it is
    (no spec matches) or with the matching rows poisoned, sleeps
    (straggler), or raises :class:`InjectedFault`.  ``triggered`` logs
    every firing as ``(stage, kind, step, rows)``; :meth:`reset` re-arms
    every spec."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: List[FaultSpec] = list(specs)
        self.reset()

    @classmethod
    def single(cls, stage: str, kind: str, **kw) -> "FaultPlan":
        return cls([FaultSpec(stage=stage, kind=kind, **kw)])

    @classmethod
    def random(cls, seed: int, uids: Sequence[int], rate: float, *,
               stages: Sequence[str] = ("prefill", "execute", "sample"),
               kinds: Sequence[str] = ("nan", "inf", "exception"),
               max_step: int = 8) -> "FaultPlan":
        """Each uid faults with probability ``rate`` at a random (stage,
        kind, step), drawn from Python's ``random.Random(seed)`` in the
        reference's order, so a seed gives the reference's specs."""
        rng = _random.Random(seed)
        specs = []
        for uid in uids:
            if rng.random() >= rate:
                continue
            stage = rng.choice(list(stages))
            kind = rng.choice(list(kinds))
            step = None if stage == "prefill" else rng.randrange(max_step)
            specs.append(FaultSpec(stage=stage, kind=kind, uid=uid, step=step))
        return cls(specs)

    def reset(self) -> None:
        self.triggered: List[Tuple[str, str, Optional[int],
                                   Tuple[int, ...]]] = []
        self._remaining: Dict[int, int] = {
            i: s.times for i, s in enumerate(self.specs)}
        self._calls: Counter = Counter()

    def _armed(self, stage: str, *, step: Optional[int],
               layer: Optional[int]) -> List[Tuple[int, FaultSpec]]:
        out = []
        for i, s in enumerate(self.specs):
            if s.stage != stage or self._remaining.get(i, 0) <= 0:
                continue
            if s.step is not None and s.step != step:
                continue
            if s.layer is not None and s.layer != layer:
                continue
            out.append((i, s))
        return out

    def _rows_for(self, spec: FaultSpec,
                  uids: Optional[Sequence[Optional[int]]],
                  nrows: int) -> List[int]:
        if spec.row is not None:
            return [spec.row] if spec.row < nrows else []
        if spec.uid is not None:
            if uids is None:
                return []
            return [r for r, u in enumerate(uids) if u == spec.uid]
        return list(range(nrows))

    def _next_layer(self, stage: str, step: Optional[int]) -> int:
        """The index of this call among the (stage, step) hook's calls."""
        layer = self._calls[(stage, step)]
        self._calls[(stage, step)] += 1
        return layer

    def apply(self, stage: str, x: torch.Tensor, *,
              step: Optional[int] = None,
              uids: Optional[Sequence[Optional[int]]] = None
              ) -> torch.Tensor:
        """The stage hook for a batched activation ``x`` (B, ...)."""
        layer = self._next_layer(stage, step)
        for i, spec in self._armed(stage, step=step, layer=layer):
            if spec.kind == "straggler":
                self._remaining[i] -= 1
                self.triggered.append((stage, "straggler", step, ()))
                time.sleep(spec.delay_s)
                continue
            if spec.kind == "exception":
                self._remaining[i] -= 1
                self.triggered.append((stage, "exception", step, ()))
                raise InjectedFault(
                    f"injected {stage} exception (step={step}, uid={spec.uid})")
            rows = self._rows_for(spec, uids, int(x.shape[0]))
            if not rows:
                continue
            self._remaining[i] -= 1
            self.triggered.append((stage, spec.kind, step, tuple(rows)))
            x = poison_rows(x, rows, spec.kind)
        return x

    def apply_cache(self, cache: Any, *, step: Optional[int] = None,
                    uids: Optional[Sequence[Optional[int]]] = None,
                    nrows: int = 0) -> Any:
        """The quantize-stage hook: corrupt the matching rows' scale leaves
        of ``cache`` in place (:func:`corrupt_quant_scales`)."""
        layer = self._next_layer("quantize", step)
        for i, spec in self._armed("quantize", step=step, layer=layer):
            rows = self._rows_for(spec, uids, nrows)
            if not rows:
                continue
            self._remaining[i] -= 1
            self.triggered.append(("quantize", spec.kind, step, tuple(rows)))
            corrupt_quant_scales(cache, rows, spec.kind)
        return cache


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff: retry ``k`` (0-based) sleeps
    ``min(base_delay_s * multiplier**k, max_delay_s)`` first."""

    max_retries: int = 2
    base_delay_s: float = 0.0
    multiplier: float = 2.0
    max_delay_s: float = 1.0

    def delay(self, attempt: int) -> float:
        if self.base_delay_s <= 0:
            return 0.0
        return min(self.base_delay_s * self.multiplier ** attempt,
                   self.max_delay_s)

    def schedule(self) -> List[float]:
        return [self.delay(k) for k in range(self.max_retries)]


class HealthTracker:
    """Counters and a bounded event log, for ``summary()["health"]``."""

    MAX_EVENTS = 256

    def __init__(self):
        self.counters: Counter = Counter()
        self.events: List[Dict[str, Any]] = []

    def record(self, event: str, **detail) -> None:
        self.counters[event] += 1
        if len(self.events) < self.MAX_EVENTS:
            self.events.append({"event": event, **detail})

    def snapshot(self) -> Dict[str, Any]:
        return {"counters": dict(self.counters),
                "events": list(self.events)}


class DegradationLadder:
    """The fallback rungs, walked in their fixed order as failures
    accumulate: each :meth:`note_failure` counts one, and every multiple of
    ``fail_threshold`` hands the next pending rung to the driver
    (``kv_wide``: decode on a wide f32 cache; ``mask_ref``: sparse
    attention with ``impl="ref"``; ``pipeline_serial``: depth 0)."""

    RUNGS: Tuple[str, ...] = ("kv_wide", "mask_ref", "pipeline_serial")

    def __init__(self, rungs: Sequence[str], *, fail_threshold: int = 3):
        unknown = set(rungs) - set(self.RUNGS)
        if unknown:
            raise ValueError(f"unknown ladder rungs: {sorted(unknown)}")
        if fail_threshold < 1:
            raise ValueError("fail_threshold must be >= 1")
        self.pending: List[str] = [r for r in self.RUNGS if r in set(rungs)]
        self.applied: List[str] = []
        self.fail_threshold = int(fail_threshold)
        self.failures = 0

    @classmethod
    def for_serving(cls, *, kv_quant, attn_mask, pipeline_depth: int,
                    fail_threshold: int = 3) -> "DegradationLadder":
        """The rungs that apply to a driver's configuration."""
        rungs = []
        if kv_quant is not None:
            rungs.append("kv_wide")
        if attn_mask is not None and getattr(attn_mask, "impl", "ref") != "ref":
            rungs.append("mask_ref")
        if pipeline_depth > 0:
            rungs.append("pipeline_serial")
        return cls(rungs, fail_threshold=fail_threshold)

    def note_failure(self) -> Optional[str]:
        """Count one failure; the next rung when the count crosses the
        threshold, else None."""
        self.failures += 1
        if self.pending and self.failures % self.fail_threshold == 0:
            rung = self.pending.pop(0)
            self.applied.append(rung)
            return rung
        return None

    def state(self) -> Dict[str, Any]:
        return {"failures": self.failures,
                "fail_threshold": self.fail_threshold,
                "applied": list(self.applied),
                "pending": list(self.pending)}
