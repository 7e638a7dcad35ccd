"""Serving launcher of the port: the static-batch ``ServeLoop`` and the
continuous-batching ``ServeScheduler``, over one phase machinery
(``_ServeBase``).

``ServeLoop``: one prefill over a fixed (B, S) prompt batch, then lockstep
one-token decode steps, in one of two modes, picked by ``two_phase`` as
the reference picks them (default: two-phase exactly when the backend is
``"bcsr"`` and the stack has attn+moe layers):

* **two-phase** (``two_phase=True``): layer by layer and eagerly
  (``model.prefill_layered`` / ``model.decode_step_layered``).  With
  ``"bcsr"`` every attn+moe layer routes on the host (``moe.route_moe``:
  router, slot cumsums, routed-stream compaction to a bucketed
  :class:`BatchedBCSR`) and then executes (``moe.execute_moe``: the SpMM
  kernel's dispatch, expert FFN, combine); with ``"gather"`` it is one
  ``moe.apply_moe`` call (the reference splits gather into route and
  execute too; the tokens are the same).
* **fused** (``two_phase=False``; the default for gather dispatch and for
  stacks without attn+moe, such as rwkv6-7b): ``model.prefill``, then
  ``model.decode_step`` on a static cache with position and token buffers
  on the device (:class:`_FusedDecode`).  On the card the step is one
  CUDA graph a (batch, ``max_seq``, cache dtype), captured once and
  replayed every step; on the CPU it runs eagerly.  ``"bcsr"`` runs
  through the full-grid stream built on the device, as the reference's
  fused path does.

Both modes, and both backends, give the same tokens.

``ServeScheduler``: a queue of requests served from a fixed pool of cache
slots (batch rows of one decode cache).  Between decode steps it evicts a
request at its token budget or its EOS and admits a queued prompt into the
lowest free slot with a single-request prefill; every decode step advances
each resident request one token, over the occupied slots rounded up to a
power-of-two batch bucket, each row at its own position.  A request's
greedy tokens equal the request served alone through ``ServeLoop`` with
the same ``max_seq``, whoever shares its batch: on the CPU
(``tests/test_torch_scheduler.py``) and on the card, where the two decode
products whose library kernel depends on the batch count run as kernels
with one summation order per row (decode attention D1, the router R1;
``chip_smoke.py`` holds the 16 requests of its trace to this).

``pipeline_depth`` (default 0), both drivers:

* ``0`` -- fully serial: each phase waits for the device
  (``torch.cuda.synchronize``) before reading the clock, and the route
  clock starts only after the attention half has drained, so queued device
  work is never charged to routing.
* ``1`` -- pipelined: each attn+moe layer's route phase 1 is dispatched with
  its attention half (``route_ahead``), so the host fetches only the small
  slot stream; the dispatched execute stays in flight
  (``engine.StreamPipeline``) behind the next layer's host route.  In
  ``ServeLoop`` the sampled token feeds the next step's embedding on the
  device: decode makes no per-step host sync beyond the slot fetches, and
  one drain ends it.  ``ServeScheduler`` fetches the step's (bucket,) token
  ids once, for its EOS and evict decisions.  Tokens equal depth 0's at any
  temperature, on both backends; ``summary()["timing"]`` says how much
  route time the overlap hid (``route_hidden_frac``).

``ServeScheduler`` takes ``two_phase`` with ``ServeLoop``'s default and
modes.  Two-phase, its admissions and decode steps are layered and eager.
Fused, an admission is ``model.prefill`` and a decode step is
``model.decode_step`` on the slot pool's own rows ``[0, bucket)``: on the
card one CUDA graph a batch bucket, captured at the bucket's first use (the
rows' live requests restored after the warm-up) and replayed every step,
all of them in one memory pool; on the CPU eagerly.  Either way a step
fetches its sampled ids once.

``attn_mask`` (an ``AttnMaskSpec``) sends every prefill attention layer it
applies to through the masked flash kernels (K4s stream walk or K4m masked
grid); decode is untouched.

``quantize_experts`` and ``kv_quant`` (narrow dtype names, both drivers,
both modes), as in the reference: the expert weights are BlockQuant'ed
once at construction (``moe.quantize_model_experts``; each matrix
dequantized at its ``bmm``), and the attention caches are stored as
narrow values with per-position f32 scales (``model.init_cache`` /
``prefill(kv_quant=)``; dequantized before decode attention).

**Resilience** (``runtime.resilience``, the reference's contract in
``tests/README.md`` "Resilience contract"), both drivers, both modes:
``fault_plan`` fires its hooks at the reference's stages and with its step
labels -- ``prefill`` on the prefill logits, ``quantize`` on the cache
(in place: on the card the captured graphs read the same storage) after
prefill and before each decode step, ``sample`` on each step's logits,
and, two-phase, ``attention`` / ``route`` before each attn+moe layer's
MoE and ``execute`` on its output, for both backends.  Each decode step
computes ``isfinite`` of every row's logits on the device: ``ServeLoop``
folds it into a mask fetched once a run (``health_rows``);
``ServeScheduler`` fetches it with the step's token ids in the step's one
transfer, fails a poisoned row's request alone, blanks its cache row
(``model.blank_cache_row``) and keeps serving the others.  The
scheduler retries a failed prefill or decode step under ``retry`` (a
``RetryPolicy``), sheds requests past their deadlines or beyond a bounded
queue, and walks the ``DegradationLadder`` as failures reach
``fail_threshold``.  The port's decode step writes its cache in place, so
before each decode try the scheduler copies the leaves a step advances
beyond a row's position (MoE occupancy, RWKV state and shifts) into
buffers made once, and a retry starts from them: the same pool, hence
the same tokens, as a step that never failed.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --dispatch bcsr --gen 8 \
      --attn-mask local_global --attn-mask-impl sparse --pipeline-depth 1
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --dispatch bcsr --two-phase off
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --dispatch bcsr --continuous \
      --two-phase off --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --quantize-experts int8 \
      --kv-quant int8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.core.precision import QUANT_DTYPES, QuantTensor
from repro_torch.kernels import engine
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.runtime import resilience as R


@dataclasses.dataclass
class StepStat:
    """One timed phase of the loop; ``extra`` carries phase-specific detail
    (e.g. the route phase's nnzb stream accounting)."""
    phase: str          # prefill | route | execute | decode | drain | capture
    step: int           # decode step index (-1 for prefill)
    seconds: float
    tokens: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def sample_tokens(last_logits: torch.Tensor, vocab_size: int,
                  temperature: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """The next token (B, 1) int32 from (B, V) logits: the argmax at
    temperature 0, else one draw from ``softmax(logits / temperature)`` as
    ``argmax(p / q)``, ``q ~ Exp(1)`` from ``generator`` -- the one-sample
    path of ``torch.multinomial``, with its generator use and tokens, but
    without the two ``.item()`` validity checks by which it waits for the
    device.  Nothing here syncs with the host."""
    lg = last_logits[:, :vocab_size]
    if temperature > 0:
        probs = torch.softmax(lg / temperature, dim=-1)
        q = torch.empty_like(probs).exponential_(1, generator=generator)
        nxt = torch.argmax(probs / q, dim=-1)
    else:
        nxt = torch.argmax(lg, dim=-1)
    return nxt[:, None].to(torch.int32)


def _percentiles_ms(seconds: List[float]) -> Dict[str, float]:
    """p50 / p99 / mean of a latency sample in milliseconds, and its size;
    an empty sample gives zeros, and None or non-finite entries are
    dropped."""
    seconds = [s for s in (seconds or [])
               if s is not None and np.isfinite(s)]
    if not seconds:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0, "n": 0}
    a = np.asarray(seconds, np.float64) * 1e3
    return {"p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "mean": float(a.mean()), "n": int(a.size)}


def _check_on(tree, device: torch.device, who: str) -> None:
    """Every tensor of a param tree lies on ``device`` (its type)."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif isinstance(tree, QuantTensor):
        tree = (tree.values, tree.scales)
    elif isinstance(tree, torch.Tensor):
        if tree.device.type != device.type:
            raise ValueError(f"{who}: a param on {tree.device}, driver on "
                             f"{device}")
        return
    for leaf in tree:
        _check_on(leaf, device, who)


def _copy_leaves(dst, src) -> None:
    """Every leaf of ``src`` into the same leaf of ``dst``, in place; a
    leaf of another dtype converts as ``.to`` does."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_leaves(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_leaves(d, s)
    else:
        dst.copy_(src)


def _clone_leaves(tree):
    if isinstance(tree, dict):
        return {k: _clone_leaves(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone_leaves(v) for v in tree)
    return tree.clone()


# the leaves a decode step advances beyond a row's position; K / V are
# written at the position (a ring's at its slot, position % window), which a
# retried step rewrites with the same values
_STEP_STATE = ("moe", "wkv", "shift_t", "shift_c", "conv", "ssm")


def _step_state(cache):
    """The :data:`_STEP_STATE` leaves of a stacked cache, slot by slot,
    the prologue's last."""
    slots = cache["slots"] + ((cache["prologue"],) if "prologue" in cache
                              else ())
    return tuple({k: v for k, v in slot.items() if k in _STEP_STATE}
                 for slot in slots)


@contextlib.contextmanager
def _rows_kept(cache):
    """Every leaf of ``cache`` as it was on entry, copied back into the
    same storage on exit (error or not): the guard around the warm-up
    steps of a step made over rows that hold live requests."""
    saved = _clone_leaves(cache)
    try:
        yield
    finally:
        _copy_leaves(cache, saved)


class _FusedDecode:
    """The fused mode's decode step at one (batch, ``max_seq``, cache
    dtype): a decode cache at the dtypes a step writes, a ``(B, 1)`` token
    buffer and a ``(B,)`` position buffer on the device, and
    ``model.decode_step`` on them.  The cache is the step's own static one
    (``model.init_cache``, quantized with ``kv_quant``; :meth:`load`
    overwrites it whole, scale leaves too), or ``cache``
    when given: rows of a longer-lived cache, such as a scheduler's slot
    pool, which the step then reads and writes in place.

    On the card the step is one CUDA graph, captured when this is made and
    replayed by :meth:`step`, in the memory pool ``pool`` when given (the
    steps of one scheduler share one; only one replays at a time).  Before
    the capture two warm-up steps run on a side stream under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside the
    step raises there, before it could break the capture, and each
    kernel's first-use build and shared-memory attribute are done.  The
    warm-up writes into the cache (K/V at the buffers' positions, the MoE
    occupancy, the RWKV and Mamba states, shifts and conv carries): a
    cache of the step's own is overwritten by :meth:`load`, a given one is
    restored leaf by leaf after the capture (:func:`_rows_kept`), so its
    live rows leave the capture as they entered it.  The graph binds the
    given cache's own storage, never a copy.  A replay runs no wrapper, so
    the launches the capture recorded (``launches``) are added to the
    kernels' counts at every replay; the warm-up and the capture add none.  A failed capture
    or replay raises: there is no eager fallback on the card.  On the CPU
    :meth:`step` runs ``model.decode_step`` eagerly on the same buffers; a
    given cache gets the same warm-up steps there, under the same guard."""

    WARMUP = 2

    def __init__(self, params, cfg, batch: int, max_seq: int, *,
                 dispatch: str, cache_dtype, device: torch.device,
                 cache=None, pool=None, kv_quant: Optional[str] = None):
        self.params, self.cfg, self.dispatch = params, cfg, dispatch
        self.cache = cache if cache is not None else M.to_decode_dtypes(
            cfg, M.init_cache(cfg, batch, max_seq, dtype=cache_dtype,
                              device=device, kv_quant=kv_quant))
        self.tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                  device=device)
        self.pos = torch.zeros((batch,), dtype=torch.int64, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        guard = (_rows_kept(self.cache) if cache is not None
                 else contextlib.nullcontext())
        with guard:
            if device.type == "cuda":
                self._capture(device, pool)
            elif cache is not None:
                for _ in range(self.WARMUP):
                    self._decode()

    def _decode(self) -> torch.Tensor:
        logits, _ = M.decode_step(self.params, self.cfg, self.cache,
                                  self.pos, self.tokens,
                                  dispatch=self.dispatch)
        return logits

    def _capture(self, device: torch.device, pool) -> None:
        self.graph, self.logits, self.launches = kernels.capture_graph(
            self._decode, device, pool=pool, warmup=self.WARMUP)

    def load(self, cache) -> None:
        """A prefill cache into the static cache, leaf by leaf (the
        prologue's too)."""
        _copy_leaves(self.cache, cache)

    def step(self, pos, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step from the (B, 1) ``tokens`` on the device at
        write position ``pos``: an int for every row, or a (B,) numpy
        vector of per-row positions, uploaded without blocking the host
        (``moe._upload``).  Returns the (B, 1, V) f32 logits (on the card
        the graph's output buffer, which the next replay of a graph in the
        same pool overwrites)."""
        if isinstance(pos, np.ndarray):
            self.pos.copy_(moe._upload(pos.astype(np.int64),
                                       self.pos.device))
        else:
            self.pos.fill_(pos)
        self.tokens.copy_(tokens)
        if self.graph is None:
            return self._decode()
        self.graph.replay()
        kernels.add_launches(self.launches)
        return self.logits


class _ServeBase:
    """Phase machinery shared by :class:`ServeLoop` and
    :class:`ServeScheduler`: the dispatch backend, the two-phase route ->
    execute MoE stage with its per-phase stats, the ``StreamPipeline`` of
    in-flight executes, the timing summary, and the resilience state: the
    fault plan's hooks, the retry policy, the health counters and the
    degradation ladder."""

    # the fused mode's graphs share this memory pool (the scheduler's)
    _graph_pool = None

    def __init__(self, params, cfg, *, dispatch: Optional[str],
                 temperature: float, sample_seed: int, pipeline_depth: int,
                 attn_mask: Optional[AttnMaskSpec], device,
                 two_phase: Optional[bool] = None,
                 quantize_experts: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 fault_plan: Optional[R.FaultPlan] = None,
                 retry: Optional[R.RetryPolicy] = None,
                 fail_threshold: int = 3):
        self.device = resolve_device(device)
        _check_on(params, self.device, type(self).__name__)
        M._check_kinds(cfg)
        for name, q in (("quantize_experts", quantize_experts),
                        ("kv_quant", kv_quant)):
            if q is not None and q not in QUANT_DTYPES:
                raise ValueError(f"{name}={q!r}; choose from "
                                 f"{sorted(QUANT_DTYPES)} or None")
        self.quantize_experts, self.kv_quant = quantize_experts, kv_quant
        if quantize_experts:
            # once, here: the QuantTensor leaves then flow through every
            # execute path, each matrix dequantized at its bmm
            params = moe.quantize_model_experts(params, quantize_experts)
        self.params, self.cfg = params, cfg
        self.backend = dispatch or cfg.moe_dispatch
        if self.backend not in ("gather", "bcsr"):
            raise ValueError(f"unknown moe_dispatch backend {self.backend!r}")
        self.two_phase = (self.backend == "bcsr"
                          and "attn+moe" in cfg.block_unit
                          if two_phase is None else bool(two_phase))
        self.temperature = temperature
        self.attn_mask = attn_mask
        self._pipe = engine.StreamPipeline(pipeline_depth)
        self.pipeline_depth = pipeline_depth
        # oracle fallbacks are counted from this driver's own baseline
        self._fallback_base = flash_ops.fallback_count()
        self._sample_seed = sample_seed
        self.stats: List[StepStat] = []
        self.cache = None
        self._fused: Dict[int, _FusedDecode] = {}
        # two-phase: the distinct execute signatures (:meth:`_note_execute`)
        self._exec_keys: set = set()
        self.fault_plan = fault_plan
        self.retry = retry if retry is not None else R.RetryPolicy()
        self.health = R.HealthTracker()
        self.ladder = R.DegradationLadder.for_serving(
            kv_quant=kv_quant, attn_mask=attn_mask,
            pipeline_depth=pipeline_depth, fail_threshold=fail_threshold)
        self._row_uids: Optional[List[Optional[int]]] = None

    # ---------------------------------------------------------- resilience --

    def _fault(self, stage: str, x: torch.Tensor, *,
               step: Optional[int] = None) -> torch.Tensor:
        """The fault plan's hook for a batched activation; ``x`` itself
        without a plan."""
        if self.fault_plan is None:
            return x
        return self.fault_plan.apply(stage, x, step=step, uids=self._row_uids)

    def _fault_cache(self, cache, *, step: Optional[int] = None, uids=None,
                     nrows: int = 0) -> None:
        """The quantize-stage hook: corrupts the plan's rows of ``cache``
        in place."""
        if self.fault_plan is not None:
            self.fault_plan.apply_cache(cache, step=step, uids=uids,
                                        nrows=nrows)

    def _note_failure(self) -> None:
        """Count one failure on the ladder; apply the rung it hands back."""
        rung = self.ladder.note_failure()
        if rung is not None:
            self._apply_rung(rung)

    def _apply_rung(self, rung: str) -> None:
        """One degradation, recorded as a "degrade" event.  ``kv_wide``:
        the live cache dequantized to a wide f32 one (a new pool), every
        later prefill and step with ``kv_quant=None``; fused, every bucket's
        step and graph dropped (and the scheduler's graph pool), so each is
        made, and on the card captured, again at its next use over the wide
        pool.  ``mask_ref``: ``attn_mask`` with ``impl="ref"`` (counted by
        ``flash_ops.fallback_count()``).  ``pipeline_serial``: depth 0."""
        self.health.record("degrade", rung=rung)
        if rung == "kv_wide":
            self._pipe.abort()
            if self.cache is not None:
                self.cache = R.dequantize_cache(self.cache, torch.float32)
            self.kv_quant = None
            self._fused = {}
            if self._graph_pool is not None:
                self._graph_pool = torch.cuda.graph_pool_handle()
        elif rung == "mask_ref":
            self.attn_mask = dataclasses.replace(self.attn_mask, impl="ref")
        elif rung == "pipeline_serial":
            self._pipe.abort()
            self.pipeline_depth = 0
            self._pipe = engine.StreamPipeline(0)

    # ------------------------------------------------------------- phases --

    def _step_label(self) -> int:
        """The decode step index the phase stats carry (-1 = prefill)."""
        raise NotImplementedError

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fused_step(self, batch: int, **kw) -> _FusedDecode:
        """``self._fused[batch]``, made with ``kw`` at its first use (on the
        card captured: a "capture" stat, counted in no other phase)."""
        if batch not in self._fused:
            t0 = time.monotonic()
            self._fused[batch] = _FusedDecode(
                self.params, self.cfg, batch, self.max_seq,
                dispatch=self.backend, device=self.device, **kw)
            if self._fused[batch].graph is not None:
                self._sync()
                self.stats.append(StepStat("capture", self._step_label(),
                                           time.monotonic() - t0))
        return self._fused[batch]

    def _routed(self) -> bool:
        """Whether attn+moe layers route on the host, then execute."""
        return self.two_phase and self.backend == "bcsr"

    def _moe_fn(self):
        return self._moe_two_phase if self._routed() else self._moe_gather

    def _note_execute(self, plan: moe.MoEPlan, h: torch.Tensor) -> None:
        """Record the execute's signature, the reference's phase-2 compile
        key: (capacity, backend, ``h``'s shape, and for "bcsr" the stream's
        nnzb and shape).  The port compiles nothing; the count of distinct
        signatures (``compile_signatures`` in the summary) is the number of
        execute shapes one captured graph a shape would need."""
        self._exec_keys.add((plan.capacity, plan.backend, tuple(h.shape),
                             None if plan.stream is None
                             else (plan.stream.nnzb,)
                             + tuple(plan.stream.shape)))

    def _moe_gather(self, p_ffn, h, cfg, counts=None, pos=None):
        """Two-phase gather's MoE stage: ``moe.apply_moe``'s two halves
        back to back (no host read between them), with the fault hooks of
        :meth:`_moe_two_phase` around them at the same points
        (``attention`` and ``route`` on ``h``, ``execute`` on the output)
        and its execute signature, so each call counts once a layer as the
        reference's route -> execute stage does."""
        step = self._step_label()
        h = self._fault("attention", h, step=step)
        h = self._fault("route", h, step=step)
        plan, _ = moe.route_moe(p_ffn, h, cfg, counts=counts, pos=pos,
                                dispatch=self.backend)
        self._note_execute(plan, h)
        out, counts = moe.execute_moe(p_ffn, h, plan, cfg)
        return self._fault("execute", out, step=step), counts

    def _route_ahead(self) -> bool:
        return self._routed() and self.pipeline_depth > 0

    def _moe_two_phase(self, p_ffn, h, cfg, counts=None, pos=None,
                       phase1=None):
        """The route -> execute stage injected at every attn+moe layer.

        Depth 0: ``h`` is drained BEFORE the route clock starts (the
        attention half is queued device work, not routing), and the execute
        result is waited for, so every phase wall is honest device time.

        Depth 1: no drain.  ``phase1`` (dispatched with the attention half)
        leaves the route the slot fetch and the host compaction
        (``moe.plan_from_phase1``); the dispatched execute is pushed into
        the pipeline, not waited for.  The route stat's ``hidden_s`` is its
        fetch wait when an execute was still running on the device at route
        entry, else 0 (always 0 at depth 0).

        The fault hooks: ``attention`` and ``route`` on ``h`` before the
        route, ``execute`` on the execute's output before it is pushed."""
        step = self._step_label()
        h = self._fault("attention", h, step=step)
        h = self._fault("route", h, step=step)
        pipelined = self.pipeline_depth > 0
        drain_s = 0.0
        if not pipelined:
            t_d = time.monotonic()
            self._sync()
            drain_s = time.monotonic() - t_d
        busy = pipelined and self._pipe.busy()
        t0 = time.monotonic()
        if phase1 is not None:
            plan, info = moe.plan_from_phase1(phase1, cfg,
                                              dispatch=self.backend,
                                              dtype=h.dtype, device=h.device)
        else:
            plan, info = moe.route_moe(p_ffn, h, cfg, counts=counts, pos=pos,
                                       dispatch=self.backend)
        self.stats.append(StepStat(
            "route", step, time.monotonic() - t0,
            tokens=h.shape[0] * h.shape[1],
            extra={**info, "drain_s": drain_s, "pipelined": pipelined,
                   "hidden_s": info["wait_s"] if busy else 0.0}))
        self._note_execute(plan, h)
        t0 = time.monotonic()
        out, new_counts = moe.execute_moe(p_ffn, h, plan, cfg)
        out = self._fault("execute", out, step=step)
        # depth 0: waits the execute out; depth 1: leaves it in flight
        self._pipe.push(plan, out)
        self.stats.append(StepStat(
            "execute", step, time.monotonic() - t0,
            tokens=h.shape[0] * h.shape[1],
            extra={"nnzb_stream": info.get("nnzb_stream"),
                   "compile_signatures": len(self._exec_keys),
                   "dispatch_only": pipelined}))
        return out, new_counts

    def _phase_summary(self) -> Dict[str, Any]:
        """Per-phase seconds and calls, the routed-stream accounting, the
        ``timing`` split and ``compile_signatures`` (two-phase) or the
        graph captures (fused; see :meth:`ServeLoop.summary`)."""
        out: Dict[str, Any] = {}
        for phase in ("prefill", "route", "execute", "decode", "drain"):
            ss = [s for s in self.stats if s.phase == phase]
            if ss:
                out[phase] = {"seconds": sum(s.seconds for s in ss),
                              "calls": len(ss)}
        routes = [s for s in self.stats if s.phase == "route"]
        execs = [s for s in self.stats if s.phase == "execute"]
        if routes:
            out["stream"] = {
                "nnzb_stream_mean": float(np.mean(
                    [s.extra["nnzb_stream"] for s in routes])),
                "nnzb_routed_mean": float(np.mean(
                    [s.extra["nnzb_routed"] for s in routes])),
                "grid_nnzb": routes[-1].extra["grid_nnzb"],
            }
        route_s = sum(s.seconds for s in routes)
        wait_s = sum(s.extra["wait_s"] for s in routes)
        hidden_s = sum(s.extra["hidden_s"] for s in routes)
        out["timing"] = {
            "host_route_ms": (route_s - wait_s) * 1e3,
            "route_wait_ms": wait_s * 1e3,
            "attn_drain_ms": sum(s.extra["drain_s"] for s in routes) * 1e3,
            "device_execute_ms": sum(s.seconds for s in execs
                                     if not s.extra["dispatch_only"]) * 1e3,
            "execute_dispatch_ms": sum(s.seconds for s in execs
                                       if s.extra["dispatch_only"]) * 1e3,
            "route_hidden_ms": hidden_s * 1e3,
            "route_hidden_frac": hidden_s / route_s if route_s > 0 else 0.0,
            "attention_ref_fallbacks":
                flash_ops.fallback_count() - self._fallback_base}
        out["pipeline"] = {"depth": self.pipeline_depth}
        if self.two_phase:
            out["compile_signatures"] = len(self._exec_keys)
        else:
            caps = [s.seconds for s in self.stats if s.phase == "capture"]
            out["capture"] = {"calls": len(caps), "ms": sum(caps) * 1e3}
        out["health"] = {
            **self.health.snapshot(), "ladder": self.ladder.state(),
            "faults_triggered": (list(self.fault_plan.triggered)
                                 if self.fault_plan is not None else [])}
        return out


class ServeLoop(_ServeBase):
    """Batched greedy/temperature serving loop with KV caches.

    Parameters
    ----------
    params, cfg : the model (every param on ``device``).
    max_seq : decode-cache capacity (frontend positions + prompt +
        generation).
    dispatch : MoE dispatch backend ("gather" | "bcsr"); default is the
        config's ``moe_dispatch``.
    two_phase : None (default) = the reference's rule, two-phase exactly
        when ``dispatch`` is "bcsr" and the stack has attn+moe layers;
        True = the layered path for any stack; False = the fused mode
        (``model.prefill`` and the captured ``model.decode_step``; "bcsr"
        through the full-grid stream).
    temperature : 0 = greedy argmax, > 0 = sampling from
        ``softmax(logits / temperature)`` (:func:`sample_tokens`) with a
        ``torch.Generator`` reseeded from ``sample_seed`` at every
        :meth:`run`.
    pipeline_depth : 0 = fully serial; 1 = pipelined (route phase 1 ahead
        with the attention half, executes in flight behind the next host
        route, no per-step host sync; the same tokens).  Anything else
        raises ``ValueError``.
    attn_mask : an ``AttnMaskSpec`` for prefill attention (``impl``
        "sparse" | "dense" | "ref"), or None.
    quantize_experts : a narrow dtype name ("fp8_e4m3" | "fp8_e5m2" |
        "int8") to BlockQuant the expert FFN weights at construction
        (``moe.quantize_model_experts``: one f32 scale per expert and
        output channel), or None (default): the params as they are.
    kv_quant : a narrow dtype name to store the attention caches as
        per-position narrow values and f32 scales, or None (default): the
        wide cache, bit for bit.
    fault_plan : a ``resilience.FaultPlan`` whose hooks the loop fires at
        the ``prefill``, ``quantize``, ``sample`` and (two-phase)
        ``attention`` / ``route`` / ``execute`` stages, or None (default):
        no hook does anything.  Every run folds each step's per-row
        ``isfinite`` of the logits into a mask on the device, fetched
        with the tokens at the run's end as ``health_rows`` (and
        ``summary()["health"]["rows_finite"]``).
    retry, fail_threshold : carried for ``summary()`` as in the
        reference: the loop never retries and never walks the ladder; an
        exception mid-run releases the pipeline and propagates.
    device : where the loop runs; "cuda" (default) raises without a GPU.
    """

    def __init__(self, params, cfg, *, max_seq: int,
                 dispatch: Optional[str] = None,
                 two_phase: Optional[bool] = None, temperature: float = 0.0,
                 sample_seed: int = 3, pipeline_depth: int = 0,
                 attn_mask: Optional[AttnMaskSpec] = None,
                 quantize_experts: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 fault_plan: Optional[R.FaultPlan] = None,
                 retry: Optional[R.RetryPolicy] = None,
                 fail_threshold: int = 3, device="cuda"):
        super().__init__(params, cfg, dispatch=dispatch,
                         temperature=temperature, sample_seed=sample_seed,
                         pipeline_depth=pipeline_depth, attn_mask=attn_mask,
                         device=device, two_phase=two_phase,
                         quantize_experts=quantize_experts,
                         kv_quant=kv_quant, fault_plan=fault_plan,
                         retry=retry, fail_threshold=fail_threshold)
        self.max_seq = max_seq
        self._gen = torch.Generator(device=self.device)
        self.pos: Optional[int] = None
        self.generated: List[torch.Tensor] = []
        # the fused mode's steps (``_fused``) are one a batch (max_seq and
        # the bf16 cache are the loop's); their graphs and memory pools go
        # with the loop
        self.fused_step: Optional[_FusedDecode] = None   # the last prefill's
        # the run's per-row health: on the device, fetched once a run
        self._health_dev: Optional[torch.Tensor] = None
        self.health_rows: Optional[np.ndarray] = None

    def _step_label(self) -> int:
        return len(self.generated) - 1

    # ------------------------------------------------------------- phases --

    def prefill(self, prompts, embeddings=None) -> torch.Tensor:
        """Run the prompts (B, S) through the model, fill the decode cache,
        and emit the first generated token (B, 1).  ``embeddings`` (B, F,
        d_model), a frontend's precomputed embeddings, are moved to the
        loop's device and prepended to the prompts' (``model.prefill``);
        decode then starts at position F + S.  Fused, the prefill cache is
        copied into the step's static cache, after the step of this batch
        is made (and captured) at its first use.  Ends with the device
        drained at either depth."""
        prompts = torch.as_tensor(prompts, device=self.device)
        if embeddings is not None:
            embeddings = torch.as_tensor(embeddings, device=self.device)
        self.generated = []
        if not self.two_phase:
            self.fused_step = self._fused_step(prompts.shape[0],
                                               cache_dtype=torch.bfloat16,
                                               kv_quant=self.kv_quant)
        t0 = time.monotonic()
        if self.two_phase:
            logits, cache, pos = M.prefill_layered(
                self.params, prompts, self.cfg, max_seq=self.max_seq,
                moe_fn=self._moe_fn(), attn_mask=self.attn_mask,
                route_ahead=self._route_ahead(), kv_quant=self.kv_quant,
                embeddings=embeddings)
        else:
            logits, cache, pos = M.prefill(
                self.params, prompts, self.cfg, max_seq=self.max_seq,
                attn_mask=self.attn_mask, dispatch=self.backend,
                kv_quant=self.kv_quant, embeddings=embeddings)
            self.fused_step.load(cache)
            cache = self.fused_step.cache
        self._sync()
        self._pipe.drain()
        logits = self._fault("prefill", logits, step=-1)
        self._fault_cache(cache, step=-1, nrows=prompts.shape[0])
        # the prompts' tokens, as the reference counts them: the frontend
        # positions are not tokens
        self.stats.append(StepStat("prefill", -1, time.monotonic() - t0,
                                   tokens=prompts.numel()))
        self.cache, self.pos = cache, pos
        self._health_dev = self._finite(logits)
        nxt = self._sample(logits[:, -1])
        self.generated = [nxt]
        return nxt

    def _finite(self, logits: torch.Tensor) -> torch.Tensor:
        """(B,) bool on the device: every logit of the row's last position
        finite."""
        return torch.isfinite(logits[:, -1, :self.cfg.vocab_size]).all(-1)

    def _sample(self, last_logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(last_logits, self.cfg.vocab_size,
                             self.temperature, self._gen)

    def decode_step(self) -> torch.Tensor:
        """Generate one token for every sequence in the batch.  At depth 1
        the step is only dispatched (its stat ``dispatch_only``): the
        sampled token stays on the device and feeds the next step.  Fused,
        the step fills the position buffer and copies the last token into
        the token buffer on the device, then replays the graph (on the
        CPU: runs ``model.decode_step``); sampling stays outside, with the
        loop's generator.  Raises before any write on a KV-cache
        overflow."""
        if self.cache is None:
            raise RuntimeError("decode_step before prefill")
        step = self._step_label()
        pos = self.pos + step
        if pos >= self.max_seq:
            raise RuntimeError(
                f"ServeLoop.decode_step: KV-cache overflow -- decode write "
                f"position {pos} >= max_seq {self.max_seq}. Raise max_seq or "
                f"generate fewer tokens.")
        tok = self.generated[-1]
        self._fault_cache(self.cache, step=step, nrows=tok.shape[0])
        t0 = time.monotonic()
        if self.two_phase:
            logits, self.cache = M.decode_step_layered(
                self.params, self.cfg, self.cache, pos, tok,
                moe_fn=self._moe_fn(), route_ahead=self._route_ahead())
        else:
            logits = self.fused_step.step(pos, tok)
        logits = self._fault("sample", logits, step=step)
        self._health_dev = self._health_dev & self._finite(logits)
        if self.pipeline_depth > 0:
            nxt = self._sample(logits[:, -1])
            self.stats.append(StepStat("decode", step, time.monotonic() - t0,
                                       tokens=tok.shape[0],
                                       extra={"dispatch_only": True}))
        else:
            self._sync()
            self.stats.append(StepStat("decode", step, time.monotonic() - t0,
                                       tokens=tok.shape[0]))
            nxt = self._sample(logits[:, -1])
        self.generated.append(nxt)
        return nxt

    def decode(self, n: int) -> None:
        """``n`` decode steps; at depth 1 followed by the decode phase's
        one drain (the last token, the cache and the in-flight execute),
        recorded as the "drain" stat."""
        for _ in range(n):
            self.decode_step()
        if self.pipeline_depth > 0 and self.generated:
            t0 = time.monotonic()
            self._sync()
            self._pipe.drain()
            self.stats.append(StepStat("drain", len(self.generated) - 2,
                                       time.monotonic() - t0))

    # -------------------------------------------------------------- drive --

    def run(self, prompts, gen: int, embeddings=None) -> np.ndarray:
        """prefill (with a frontend's ``embeddings``, see :meth:`prefill`)
        + (gen - 1) decode steps; returns (B, gen) token ids.
        Every run starts from a fresh sampling generator, so seeded runs
        with ``temperature > 0`` are reproducible.  The tokens and the
        run's health mask come back in one fetch (``health_rows``; a
        "rows_poisoned" health event when a row is not finite).  An
        exception mid-run releases every in-flight execute before it
        propagates."""
        self.stats.clear()
        self._exec_keys.clear()
        self._fallback_base = flash_ops.fallback_count()
        self._pipe.drain()
        self._gen.manual_seed(self._sample_seed)
        self._health_dev = self.health_rows = None
        try:
            self.prefill(prompts, embeddings=embeddings)
            self.decode(gen - 1)
        except BaseException:
            self._pipe.abort()
            raise
        host = torch.cat(self.generated + [
            self._health_dev[:, None].to(torch.int32)], dim=1).cpu().numpy()
        self.health_rows = host[:, -1].astype(bool)
        bad = int((~self.health_rows).sum())
        if bad:
            self.health.record("rows_poisoned", rows=bad)
        return np.ascontiguousarray(host[:, :-1])

    def summary(self) -> Dict[str, Any]:
        """Per-phase seconds and calls of the last :meth:`run`.  The phases
        are not disjoint: "prefill" and each "decode" step time the whole
        layered pass, inclusive of the "route" / "execute" layer calls made
        inside it; at depth 1 the decode steps are dispatch walls and the
        "drain" stat is the device's wait, so ``decode.tok_per_s`` is batch
        x steps / (decode + drain seconds).  Fused, ``capture`` holds the
        run's graph captures (``calls`` and ``ms``; 0 when the run reused
        its batch's graph, and on the CPU), counted in no other phase.
        ``stream`` is the routed-stream
        accounting of two-phase mode, and ``compile_signatures`` its count
        of distinct execute signatures (:meth:`_ServeBase._note_execute`:
        the execute shapes one graph a shape would need), both backends,
        cleared at each :meth:`run`.  ``timing`` splits the route phase
        into ``host_route_ms`` (route minus its slot-fetch wait) and
        ``route_wait_ms``, gives the attention drains before the routes
        (``attn_drain_ms``, depth 0), the waited execute walls
        (``device_execute_ms``, depth 0) and the dispatch-only ones
        (``execute_dispatch_ms``, depth 1), the route time hidden behind an
        execute in flight (``route_hidden_ms``, and its share of the route
        phase ``route_hidden_frac``, 0 at depth 0), and the run's attention
        oracle fallbacks (``attention_ref_fallbacks``, ``attn_mask`` with
        ``impl="ref"``).  ``health``: the counters and events, the
        ladder's state, the faults the plan fired and, after a run,
        ``rows_finite``."""
        out = self._phase_summary()
        dec = out.get("decode")
        if dec:
            wall = dec["seconds"] + out.get("drain", {}).get("seconds", 0.0)
            if wall > 0:
                batch = self.generated[0].shape[0]
                dec["tok_per_s"] = batch * dec["calls"] / wall
        if self.health_rows is not None:
            out["health"]["rows_finite"] = self.health_rows.tolist()
        return out


# ---------------------------------------------------- continuous batching --

def request_seed(sample_seed: int, uid: int) -> int:
    """The seed of request ``uid``'s sampling generator: numpy's
    ``SeedSequence`` hash of the pair ``(sample_seed, uid)`` (both >= 0),
    64 bits.  A function of the pair alone, so a request's draws depend on
    no neighbour, slot or step; the port's counterpart of the reference's
    ``fold_in(PRNGKey(sample_seed), uid)``, which it cannot reproduce bit
    for bit."""
    state = np.random.SeedSequence([sample_seed, uid]).generate_state(
        1, np.uint64)
    return int(state[0])


@dataclasses.dataclass
class Request:
    """One user request of the continuous-batching scheduler.

    The scheduler fills in the lifecycle fields: ``tokens`` (generated ids),
    ``latencies_s`` (wall seconds of the step that emitted each token: the
    prefill for token 0, the shared decode step after), ``slot`` (the cache
    batch row while resident), ``pos`` (next cache write position), the
    first-token latency from ``submit_time``, and ``generator``, the
    request's own sampling stream (seeded with :func:`request_seed`).
    ``state`` walks ``queued -> active -> finished``; resilience adds
    ``failed`` (a poisoned row, exhausted prefill retries or a resident
    past its deadline; ``fail_reason`` says which) and ``shed`` (refused by
    a full queue, or past a deadline while queued).  ``retries`` counts
    the request's prefill retries; ``ttft_deadline_s`` / ``deadline_s``
    bound the seconds from submission to the first / the last token."""
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    uid: int = -1
    tokens: List[int] = dataclasses.field(default_factory=list)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    pos: int = 0
    done: bool = False
    submit_time: float = 0.0
    first_token_s: Optional[float] = None
    generator: Optional[torch.Generator] = None
    state: str = "queued"      # queued | active | finished | failed | shed
    fail_reason: Optional[str] = None
    retries: int = 0
    ttft_deadline_s: Optional[float] = None
    deadline_s: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).size)


def _row_views(tree, rows: int):
    """Rows ``[0, rows)`` of every leaf of a stacked cache (batch at dim 1),
    as views: a decode step writes through them into the cache."""
    if isinstance(tree, dict):
        return {k: _row_views(v, rows) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_row_views(v, rows) for v in tree)
    return tree[:, :rows]


def _copy_row(big, small, row: int) -> None:
    """Row 0 of every leaf of ``small`` into row ``row`` of the same leaf of
    ``big``, in place; a narrower ``big`` leaf rounds the value as a cast
    to its dtype does."""
    if isinstance(big, dict):
        for k in big:
            _copy_row(big[k], small[k], row)
    elif isinstance(big, tuple):
        for b, s in zip(big, small):
            _copy_row(b, s, row)
    else:
        big[:, row].copy_(small[:, 0])


class ServeScheduler(_ServeBase):
    """Continuous-batching serving over a fixed pool of cache slots.

    A queue of :class:`Request`\\ s is served by ``n_slots`` batch rows of
    one decode cache.  Between decode steps the scheduler **evicts** a
    finished request (its token budget reached, or its EOS sampled) and
    **admits** queued prompts into free rows, the lowest first: each
    admission is a single-request (B = 1) prefill, two-phase or not as in
    :class:`ServeLoop`, and one in-place copy per cache leaf into the slot's
    row (attention K/V, MoE occupancy and RWKV state are all indexed by
    batch row, so the neighbours are untouched).  Each decode step then
    advances every resident request one token in one batched pass, each
    row at its own position.

    **Batch-bucket law.**  A decode step runs on cache rows
    ``[0, engine.batch_bucket(highest occupied slot + 1))``, a power of
    two, so the step shapes (and the routed-stream buckets) are bounded by
    the bucket count, never one per occupancy pattern.  Vacant rows inside
    the bucket compute at position 0 and are masked: they sample nothing
    and their cache rows are overwritten at the next admission.

    **Per-request sampling.**  Each request owns a ``torch.Generator`` on
    the scheduler's device, seeded with :func:`request_seed` of
    ``(sample_seed, uid)``.  At temperature > 0 a resident row's ``Exp(1)``
    draw (the ``argmax(p / q)`` rule of :func:`sample_tokens`) comes from
    its own request's generator, the first token's too; vacant rows draw
    nothing.  Both depths sample on the device and fetch the step's
    (bucket,) token ids once, the one sync the EOS and evict decisions
    need, so a depth-1 decode step syncs at most once per attn+moe layer
    (the slot fetch) plus once.  Greedy, a request's tokens equal the
    request served alone through :class:`ServeLoop` with the same
    ``max_seq``, on the CPU and on the card: a row's decode arithmetic
    does not depend on the bucket (decode attention and the router logits
    run as the kernels D1 and R1, whose order is a function of the row
    alone).  On the CPU, at any temperature, a rerun of the same requests
    gives the same tokens per uid, whatever the slot pool or the arrival
    pattern.

    The cache is allocated with every leaf in the dtype a decode step
    writes (``model.to_decode_dtypes`` once, on the whole cache), so a step
    writes through views of its rows and nothing is copied back.

    **Modes.**  ``two_phase`` is :class:`ServeLoop`'s, with its default:
    two-phase exactly for ``"bcsr"`` on a stack with attn+moe layers, fused
    otherwise.  Two-phase, admissions and decode steps are layered and
    eager (``"bcsr"`` routes on the host; ``"gather"`` is one
    ``moe.apply_moe`` call a layer).  Fused, an admission is
    ``model.prefill`` and each batch bucket's decode step is a
    :class:`_FusedDecode` over the pool's rows ``[0, bucket)``: on the card
    one CUDA graph, captured at the bucket's first use, which reads and
    writes the pool in place; the warm-up before the capture advances
    every row of the bucket, so those rows are saved before it and
    restored after the capture.  The buckets' graphs share one memory
    pool.  ``"bcsr"`` fused runs through the full-grid stream built on
    the device.  A fused step makes one host sync, the token fetch, at
    either depth.

    ``quantize_experts`` and ``kv_quant`` are :class:`ServeLoop`'s: the
    slot pool is made quantized (``model.init_cache(kv_quant=)``) and an
    admission copies the scale leaves into its row with the values.

    **Resilience.**  ``fault_plan`` fires the :class:`ServeLoop` stages
    with the reference's step labels (an admission's ``prefill`` without a
    step, its MoE stages at -1, a decode step's at ``step_idx``).  A
    decode step computes each row's ``isfinite`` on the device and fetches
    it with the sampled ids in the step's one transfer: a row that is not
    finite fails its request alone (``fail_reason``
    ``"poisoned:step<N>"``), its cache row blanked in place
    (``model.blank_cache_row``) and its slot freed; the other rows go on
    as in a run without the fault.  An admission checks its first token's
    logits the same way, in the fetch of that token, before its cache
    reaches the pool; a poisoned or raising admission is retried under
    ``retry`` (its generator put back) and fails the request once the
    retries are spent.  A decode step that raises is retried whole, and
    raises once its retries are spent.  Before each decode try the leaves
    a step advances beyond a row's position (MoE occupancy, RWKV state and
    shifts) of rows ``[0, bucket)`` are copied into buffers made once for
    the pool, and a retry copies them back first: a step, fused or
    two-phase, can fail after writing them (a layer's occupancy before an
    exception at a later layer, a replay before a sample-stage fault), and
    the retry must start from the pool the first try started from.  K / V
    at the rows' positions are left alone (a retry rewrites them with the
    same values).  With ``RetryPolicy(max_retries=0)`` nothing is saved.
    Every failure counts on the ``DegradationLadder``; its rungs apply to
    the live pool (``kv_wide``: a new wide f32 pool, and fused, every
    bucket's graph captured again at its next use).

    Parameters
    ----------
    params, cfg, dispatch, two_phase, temperature, sample_seed,
    pipeline_depth, attn_mask, quantize_experts, kv_quant, fault_plan,
    device : as :class:`ServeLoop`.
    max_seq : cache capacity of every slot; :meth:`submit` refuses a request
        that needs more.
    max_slots : the slot pool, rounded up to its own batch bucket.
    batch_min_bucket : the least decode batch bucket.
    cache_dtype : the K/V cache dtype (default bf16, as prefill's).
    retry : the ``resilience.RetryPolicy`` of failed admissions and decode
        steps (default ``RetryPolicy()``: 2 retries, no delay).
    fail_threshold : failures a rung of the degradation ladder.
    max_queue, shed_policy : a bound on the queue (None: unbounded) and
        what :meth:`submit` does at it: ``"reject"`` raises
        ``resilience.ShedError``, ``"drop_oldest"`` sheds the oldest queued
        request.
    clock : the seconds clock of submissions, deadlines and first-token
        latencies (default ``time.monotonic``); ``_sleep`` is the backoff's
        sleep.  Both can be replaced, so tests run on a fake clock.
    """

    def __init__(self, params, cfg, *, max_seq: int, max_slots: int = 8,
                 dispatch: Optional[str] = None,
                 two_phase: Optional[bool] = None, temperature: float = 0.0,
                 sample_seed: int = 3, batch_min_bucket: int = 1,
                 cache_dtype=torch.bfloat16, pipeline_depth: int = 0,
                 attn_mask: Optional[AttnMaskSpec] = None,
                 quantize_experts: Optional[str] = None,
                 kv_quant: Optional[str] = None,
                 fault_plan: Optional[R.FaultPlan] = None,
                 retry: Optional[R.RetryPolicy] = None,
                 fail_threshold: int = 3, max_queue: Optional[int] = None,
                 shed_policy: str = "reject", clock=None, device="cuda"):
        if shed_policy not in ("reject", "drop_oldest"):
            raise ValueError("shed_policy must be 'reject' or 'drop_oldest'")
        super().__init__(params, cfg, dispatch=dispatch,
                         temperature=temperature, sample_seed=sample_seed,
                         pipeline_depth=pipeline_depth, attn_mask=attn_mask,
                         device=device, two_phase=two_phase,
                         quantize_experts=quantize_experts,
                         kv_quant=kv_quant, fault_plan=fault_plan,
                         retry=retry, fail_threshold=fail_threshold)
        self.max_seq = max_seq
        self.batch_min_bucket = batch_min_bucket
        # the pool at its own bucket: every clamped step bucket is a power
        # of two
        self.n_slots = engine.batch_bucket(max_slots,
                                           minimum=batch_min_bucket)
        self.cache_dtype = cache_dtype
        self.cache = M.init_cache(cfg, self.n_slots, max_seq,
                                  dtype=cache_dtype, device=self.device,
                                  kv_quant=kv_quant)
        M.to_decode_dtypes(cfg, self.cache)
        self.slots: List[Optional[Request]] = [None] * self.n_slots
        self.queue: Deque[Request] = collections.deque()
        self.finished: List[Request] = []
        self.failed: List[Request] = []
        self.shed: List[Request] = []
        self.max_queue, self.shed_policy = max_queue, shed_policy
        self._clock = clock if clock is not None else time.monotonic
        self._sleep = time.sleep
        self.step_idx = 0
        self._stat_step = -1
        self._next_uid = 0
        self.batch_buckets: set = set()
        # the fused mode's steps (``_fused``), one a batch bucket over the
        # pool's rows, share one memory pool on the card
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda"
                            and not self.two_phase else None)
        # the decode retry's saved step state (:data:`_STEP_STATE`) of
        # every slot, made at the first decode step that can retry
        self._step_saved = None

    def _step_label(self) -> int:
        return self._stat_step

    def _fused_decode(self, bucket: int) -> _FusedDecode:
        """The fused step of this bucket over rows ``[0, bucket)`` of the
        slot pool, made (and on the card captured, a "capture" stat) at
        its first use; the rows' live requests leave its warm-up as they
        entered it."""
        return self._fused_step(bucket, cache_dtype=self.cache_dtype,
                                cache=_row_views(self.cache, bucket),
                                pool=self._graph_pool)

    def _slot_uids(self, rows) -> List[Optional[int]]:
        return [r.uid if r is not None else None for r in rows]

    # -------------------------------------------------------------- admit --

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               ttft_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None) -> Request:
        """Queue a request; uids number requests in submission order.  One
        whose prompt and token budget cannot fit the cache is refused here
        (``ValueError``; its last token is sampled but never written, hence
        the ``- 1``).  At a full bounded queue (``max_queue``) the
        ``shed_policy`` applies: ``"reject"`` raises
        ``resilience.ShedError``, ``"drop_oldest"`` sheds the oldest queued
        request to make room.  ``ttft_deadline_s`` / ``deadline_s`` bound
        the seconds from now to the first / the last token: a request past
        one is shed while queued, and failed while resident past
        ``deadline_s``, at the next :meth:`step`."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("submit: max_new_tokens must be >= 1")
        need = prompt.size + max_new_tokens - 1
        if need > self.max_seq:
            raise ValueError(
                f"submit: request needs {need} cache positions "
                f"({prompt.size} prompt + {max_new_tokens} generated - 1) "
                f"but max_seq is {self.max_seq}; it could never be served "
                "without a KV-cache overflow.")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.shed_policy == "reject":
                self.health.record("shed", reason="queue_full",
                                   uid=self._next_uid)
                raise R.ShedError(
                    f"submit: admission queue full ({len(self.queue)} >= "
                    f"max_queue {self.max_queue}); request rejected "
                    f"(shed_policy='reject')")
            self._shed(self.queue.popleft(), "queue_full_drop_oldest")
        uid = self._next_uid
        self._next_uid += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(request_seed(self._sample_seed, uid))
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens,
                      eos_id=eos_id, uid=uid, submit_time=self._clock(),
                      generator=gen, ttft_deadline_s=ttft_deadline_s,
                      deadline_s=deadline_s)
        self.queue.append(req)
        return req

    def _sample_rows(self, last_logits: torch.Tensor,
                     rows: List[Optional[Request]]) -> torch.Tensor:
        """The next token of each row, (rows,) on the device: the argmax at
        temperature 0, else ``argmax(p / q)`` with row ``i``'s ``q ~
        Exp(1)`` drawn from ``rows[i]``'s own generator; a vacant row
        (None) draws nothing.  Nothing here syncs with the host."""
        lg = last_logits[:, :self.cfg.vocab_size]
        if self.temperature <= 0:
            return torch.argmax(lg, dim=-1)
        probs = torch.softmax(lg / self.temperature, dim=-1)
        q = torch.ones_like(probs)
        for i, r in enumerate(rows):
            if r is not None:
                q[i].exponential_(1, generator=r.generator)
        return torch.argmax(probs / q, dim=-1)

    def _sample_fetch(self, logits: torch.Tensor,
                      rows: List[Optional[Request]]):
        """Each row's next token and whether its last-position logits are
        all finite, computed on the device and fetched as one (2, rows)
        int64 transfer: the one host sync of a decode step (EOS, eviction
        and the health check need the values).  Returns (tokens, finite)
        numpy arrays."""
        last = logits[:, -1]
        finite = torch.isfinite(last[:, :self.cfg.vocab_size]).all(-1)
        toks = self._sample_rows(last, rows)
        host = torch.stack([toks, finite.to(toks.dtype)]).cpu().numpy()
        return host[0], host[1].astype(bool)

    def _finish_or_keep(self, req: Request, tok: int) -> None:
        if len(req.tokens) >= req.max_new_tokens or (
                req.eos_id is not None and tok == req.eos_id):
            self.slots[req.slot] = None
            req.slot = None
            req.done = True
            req.state = "finished"
            self.finished.append(req)

    # -------------------------------------------------- failure lifecycle --

    def _fail(self, req: Request, reason: str, *,
              poisoned: bool = False) -> None:
        """A request to the terminal ``failed`` state; a poisoned resident's
        cache row is blanked in place (``model.blank_cache_row``), so no
        NaN / Inf state reaches the next admission into its slot.  Counts
        on the ladder."""
        if req.slot is not None:
            slot, req.slot = req.slot, None
            self.slots[slot] = None
            if poisoned:
                M.blank_cache_row(self.cache, slot)
        req.done = True
        req.state = "failed"
        req.fail_reason = reason
        self.failed.append(req)
        self.health.record("request_failed", uid=req.uid, reason=reason)
        self._note_failure()

    def _shed(self, req: Request, reason: str) -> None:
        """A queued (never resident) request to the terminal ``shed``
        state."""
        req.done = True
        req.state = "shed"
        req.fail_reason = reason
        self.shed.append(req)
        self.health.record("shed", reason=reason, uid=req.uid)

    def _shed_expired(self, now: float) -> None:
        """Deadlines, at the top of each tick: a queued request past its
        total or first-token deadline is shed, a resident past its total
        deadline failed (its row is clean: nothing to blank)."""
        keep: Deque[Request] = collections.deque()
        for r in self.queue:
            waited = now - r.submit_time
            if r.deadline_s is not None and waited > r.deadline_s:
                self._shed(r, "deadline")
            elif r.ttft_deadline_s is not None and waited > r.ttft_deadline_s:
                self._shed(r, "ttft_deadline")
            else:
                keep.append(r)
        self.queue = keep
        for r in self.active:
            if r.deadline_s is not None and now - r.submit_time > r.deadline_s:
                self._fail(r, "deadline")

    def _backoff(self, attempt: int, **event) -> None:
        """Record retry ``attempt`` (1-based) and sleep its backoff."""
        self.health.record("retry", attempt=attempt, **event)
        delay = self.retry.delay(attempt - 1)
        if delay:
            self._sleep(delay)

    def _prefill_into(self, req: Request, slot: int) -> bool:
        """Admit ``req`` into row ``slot`` (:meth:`_prefill_attempt`), with
        retry and backoff: an attempt that raises, or whose first-token
        logits are not all finite, leaves the pool and the request's
        generator as they were, so a retry is the admission that never
        failed.  Once the retries are spent the request fails and the slot
        stays free; returns whether it was admitted."""
        last_reason = "prefill_failed"
        for attempt in range(self.retry.max_retries + 1):
            if attempt:
                req.retries += 1
                self._backoff(attempt, stage="prefill", uid=req.uid)
            try:
                ok = self._prefill_attempt(req, slot)
            except Exception as e:
                self._pipe.abort()
                last_reason = f"prefill_error:{type(e).__name__}"
                self.health.record("prefill_error", uid=req.uid,
                                   error=type(e).__name__)
                self._note_failure()
                continue
            if ok:
                return True
            last_reason = "prefill_poisoned"
            self.health.record("prefill_poisoned", uid=req.uid)
            self._note_failure()
        self._fail(req, last_reason)
        return False

    def _prefill_attempt(self, req: Request, slot: int) -> bool:
        """One single-request prefill try.  Two-phase the prefill is
        layered (at depth 1 with its routes ahead, ending with the pipeline
        drained); fused it is ``model.prefill``.  The prefill hook, then
        the first token and its finite bit in one fetch (the generator's
        state put back when the bit is False, and False returned); then the
        prefill cache into row ``slot`` (one in-place copy per leaf) and
        the quantize hook on the pool."""
        self._stat_step = -1
        self._row_uids = [req.uid]
        prompts = torch.from_numpy(req.prompt[None, :]).to(self.device)
        t0 = time.monotonic()
        try:
            if self.two_phase:
                logits, cache1, pos = M.prefill_layered(
                    self.params, prompts, self.cfg, max_seq=self.max_seq,
                    cache_dtype=self.cache_dtype, moe_fn=self._moe_fn(),
                    attn_mask=self.attn_mask,
                    route_ahead=self._route_ahead(), kv_quant=self.kv_quant)
            else:
                logits, cache1, pos = M.prefill(
                    self.params, prompts, self.cfg, max_seq=self.max_seq,
                    cache_dtype=self.cache_dtype, attn_mask=self.attn_mask,
                    dispatch=self.backend, kv_quant=self.kv_quant)
            self._sync()
            self._pipe.drain()
            logits = self._fault("prefill", logits)
        finally:
            self._row_uids = None
        dt = time.monotonic() - t0
        self.stats.append(StepStat("prefill", self.step_idx, dt,
                                   tokens=req.prompt_len,
                                   extra={"uid": req.uid, "slot": slot}))
        state = req.generator.get_state() if self.temperature > 0 else None
        toks, finite = self._sample_fetch(logits, [req])
        if not finite[0]:
            if state is not None:
                req.generator.set_state(state)
            return False
        _copy_row(self.cache, cache1, slot)
        req.slot, req.pos = slot, pos
        req.state = "active"
        self.slots[slot] = req
        self._fault_cache(self.cache, uids=self._slot_uids(self.slots),
                          nrows=self.n_slots)
        tok = int(toks[0])
        req.tokens.append(tok)
        req.latencies_s.append(dt)
        req.first_token_s = self._clock() - req.submit_time
        self._finish_or_keep(req, tok)
        return True

    def admit(self) -> List[Request]:
        """Prefill queued requests into free slots, the lowest index first
        (it keeps the occupied prefix, and with it the step's batch bucket,
        small); a request that fails its admission leaves the slot to the
        next one."""
        joined = []
        while self.queue and None in self.slots:
            req = self.queue.popleft()
            if self._prefill_into(req, self.slots.index(None)):
                joined.append(req)
        return joined

    # ------------------------------------------------------------- decode --

    @property
    def active(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def decode_step(self) -> List[Tuple[Request, int]]:
        """One batched decode step over the occupied slot prefix, rounded
        up to its batch bucket; returns the (request, token) pairs emitted.
        Two-phase it is ``model.decode_step_layered`` on the pool's rows;
        fused it fills the bucket's position and token buffers from the
        host without blocking it and replays the bucket's graph (on the
        CPU: runs ``model.decode_step``), made at the bucket's first use.
        Either way the step's sampled ids and health bits are fetched
        once.  A try that raises is retried from the saved step state
        (:meth:`_decode_attempt`) under ``retry``; when the retries are
        spent, ``RuntimeError``.  Raises before the cache write when a
        resident would write past ``max_seq`` (``submit`` makes that
        unreachable for requests it took; the fused step cannot check)."""
        active = self.active
        if not active:
            return []
        for r in active:
            if r.pos >= self.max_seq:
                raise RuntimeError(
                    f"ServeScheduler.decode_step: KV-cache overflow -- "
                    f"request {r.uid} at write position {r.pos} >= max_seq "
                    f"{self.max_seq}.")
        err: Optional[Exception] = None
        for attempt in range(self.retry.max_retries + 1):
            if attempt:
                self._backoff(attempt, stage="decode", step=self.step_idx)
            try:
                return self._decode_attempt(active, retry=attempt > 0)
            except Exception as e:
                self._pipe.abort()
                err = e
                self.health.record("decode_error", step=self.step_idx,
                                   error=type(e).__name__)
                self._note_failure()
        raise RuntimeError(
            f"ServeScheduler.decode_step: step {self.step_idx} failed "
            f"after {self.retry.max_retries} retries") from err

    def _keep_step_state(self, bucket: int, retry: bool) -> None:
        """The first try of a step copies rows ``[0, bucket)`` of the
        :data:`_STEP_STATE` leaves into the saved buffers (made once for
        the whole pool); a retry copies them back into the pool.  Device
        copies only: no allocation and no host sync a step."""
        live = _row_views(_step_state(self.cache), bucket)
        if self._step_saved is None:
            self._step_saved = _clone_leaves(_step_state(self.cache))
        saved = _row_views(self._step_saved, bucket)
        if retry:
            _copy_leaves(live, saved)
        else:
            _copy_leaves(saved, live)

    def _decode_attempt(self, active: List[Request],
                        retry: bool) -> List[Tuple[Request, int]]:
        """One decode-step try: the quantize hook on the pool, the step
        state saved (first try) or restored (a retry), the step, the sample
        hook (before any generator draws), then the one fetch of tokens
        and health bits; a row that is not finite fails its request."""
        hi = max(i for i, r in enumerate(self.slots) if r is not None) + 1
        bucket = engine.batch_bucket(hi, minimum=self.batch_min_bucket,
                                     cap=self.n_slots)
        self.batch_buckets.add(bucket)
        rows = self.slots[:bucket]
        pos = np.zeros(bucket, np.int64)
        tok = np.zeros((bucket, 1), np.int64)
        for i, r in enumerate(rows):
            if r is not None:
                pos[i], tok[i, 0] = r.pos, r.tokens[-1]
        self._fault_cache(self.cache, step=self.step_idx,
                          uids=self._slot_uids(self.slots),
                          nrows=self.n_slots)
        if self.retry.max_retries > 0:
            self._keep_step_state(bucket, retry)
        self._stat_step = self.step_idx
        fused = None if self.two_phase else self._fused_decode(bucket)
        self._row_uids = self._slot_uids(rows)
        t0 = time.monotonic()
        try:
            if fused is not None:
                logits = fused.step(pos, moe._upload(tok, self.device))
            else:
                logits, _ = M.decode_step_layered(
                    self.params, self.cfg, _row_views(self.cache, bucket),
                    pos, moe._upload(tok, self.device),
                    moe_fn=self._moe_fn(), route_ahead=self._route_ahead())
                if self.pipeline_depth == 0:
                    self._sync()
            logits = self._fault("sample", logits, step=self.step_idx)
        finally:
            self._row_uids = None
        toks, finite = self._sample_fetch(logits, rows)
        dt = time.monotonic() - t0
        self.stats.append(StepStat(
            "decode", self.step_idx, dt, tokens=len(active),
            extra={"batch_bucket": bucket, "occupied": hi,
                   "active": len(active),
                   "pipelined": self.pipeline_depth > 0}))
        emitted = []
        for i, r in enumerate(rows):
            if r is None:
                continue          # a vacant row: computed, masked here
            if not finite[i]:
                self._fail(r, f"poisoned:step{self.step_idx}",
                           poisoned=True)
                continue
            r.tokens.append(int(toks[i]))
            r.latencies_s.append(dt)
            r.pos += 1
            emitted.append((r, int(toks[i])))
            self._finish_or_keep(r, int(toks[i]))
        return emitted

    # -------------------------------------------------------------- drive --

    def step(self) -> List[Tuple[Request, int]]:
        """One scheduler tick: deadlines (:meth:`_shed_expired` on the
        injected clock), admissions into free slots, then one token for
        every resident request.  An exception releases every in-flight
        execute before it propagates."""
        try:
            self._shed_expired(self._clock())
            self.admit()
            out = self.decode_step()
        except BaseException:
            self._pipe.abort()
            raise
        self.step_idx += 1
        return out

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def run(self, max_steps: int = 1_000_000) -> Dict[int, np.ndarray]:
        """Step until the queue and the slots are empty (or ``max_steps``
        ticks), then drain the pipeline; returns {uid: generated token
        ids} of every finished request."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        self._pipe.drain()
        return {r.uid: np.asarray(r.tokens, np.int32)
                for r in self.finished}

    def summary(self) -> Dict[str, Any]:
        """Per-phase seconds and calls (a decode step includes its route /
        execute layer calls, as in :meth:`ServeLoop.summary`), decode tok/s
        over the *emitted* tokens (``decode.tokens``), per-token and
        first-token latency percentiles (``token_latency_ms``,
        ``first_token_ms``), request counts (``requests``: finished,
        queued, active, failed, shed, and the prefill retries), the decode
        batch buckets and, two-phase, the routed-stream buckets
        (``nnzb_buckets``) and ``compile_signatures`` (over the
        scheduler's life, bounded by the batch-bucket law), the ``timing``
        split and ``pipeline``; fused,
        ``capture`` holds the graph captures of the scheduler's life
        (``calls``, one a bucket on the card -- again after ``kv_wide`` --
        and none on the CPU, and ``ms``), counted in no other phase;
        ``health`` as :meth:`ServeLoop.summary`'s, with the failed and the
        shed requests (uid and reason)."""
        out = self._phase_summary()
        dec = out.get("decode")
        if dec and dec["seconds"] > 0:
            dec["tokens"] = sum(s.tokens for s in self.stats
                                if s.phase == "decode")
            dec["tok_per_s"] = dec["tokens"] / dec["seconds"]
        reqs = self.finished + self.active
        out["token_latency_ms"] = _percentiles_ms(
            [s for r in reqs for s in r.latencies_s])
        out["first_token_ms"] = _percentiles_ms(
            [r.first_token_s for r in reqs])
        out["requests"] = {"finished": len(self.finished),
                           "queued": len(self.queue),
                           "active": len(self.active),
                           "failed": len(self.failed),
                           "shed": len(self.shed),
                           "retries": sum(r.retries for r in reqs
                                          + self.failed)}
        for key in ("failed", "shed"):
            out["health"][key] = [{"uid": r.uid, "reason": r.fail_reason}
                                  for r in getattr(self, key)]
        out["batch_buckets"] = sorted(self.batch_buckets)
        if self.two_phase:
            out["nnzb_buckets"] = sorted(
                {s.extra["nnzb_stream"] for s in self.stats
                 if s.phase == "route"})
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--dispatch", choices=["config", "gather", "bcsr"],
                    default="config",
                    help="MoE dispatch backend (config = the arch's field)")
    ap.add_argument("--attn-mask", default="none",
                    choices=["none", "sliding", "local_global", "strided"],
                    help="route prefill attention through the masked flash "
                         "kernels: 'sliding' = local layers only (each "
                         "layer's own window), others additionally impose "
                         "the named long-context pattern on full-attention "
                         "layers")
    ap.add_argument("--attn-mask-impl", default="sparse",
                    choices=["sparse", "dense", "ref"],
                    help="masked-attention implementation (dense/ref are "
                         "the parity baselines)")
    ap.add_argument("--two-phase", choices=["auto", "on", "off"],
                    default="auto",
                    help="route-then-execute layered decode (auto = when "
                         "moe+bcsr); off = the fused mode, its decode step "
                         "one CUDA graph on the card (with --continuous, "
                         "one a batch bucket)")
    ap.add_argument("--pipeline-depth", type=int, choices=[0, 1], default=0,
                    help="0 = serial; 1 = route phase 1 with the attention "
                         "half, executes in flight behind the next host "
                         "route, no per-step host sync (the same tokens)")
    ap.add_argument("--continuous", action="store_true",
                    help="drive the continuous-batching scheduler on a "
                         "synthetic many-user trace instead of one static "
                         "batch")
    ap.add_argument("--requests", type=int, default=8,
                    help="--continuous: number of synthetic requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="--continuous: resident slot pool size")
    ap.add_argument("--quantize-experts", default=None,
                    choices=["fp8_e4m3", "fp8_e5m2", "int8"],
                    help="BlockQuant the expert FFN weights to this narrow "
                         "dtype (per-output-channel f32 scales)")
    ap.add_argument("--kv-quant", default=None,
                    choices=["fp8_e4m3", "fp8_e5m2", "int8"],
                    help="store the attention KV caches as narrow values + "
                         "per-position f32 scales")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    attn_mask = None
    if args.attn_mask != "none":
        pattern = None if args.attn_mask == "sliding" else args.attn_mask
        attn_mask = AttnMaskSpec(local=True, pattern=pattern,
                                 impl=args.attn_mask_impl)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    params = M.init_params(cfg, seed=0, device=device)
    # the frontend's positions come before the prompt's
    max_seq = args.prompt_len + args.gen + (
        cfg.frontend_tokens if cfg.frontend != "none" else 0)
    dispatch = None if args.dispatch == "config" else args.dispatch
    two_phase = None if args.two_phase == "auto" else args.two_phase == "on"
    if args.continuous:
        return _main_continuous(args, cfg, params, max_seq, dispatch,
                                two_phase, attn_mask, device)
    g = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=device)
    emb = None
    if cfg.frontend != "none":      # a frontend stub's embeddings, random
        ge = torch.Generator(device=device).manual_seed(2)
        emb = 0.02 * torch.randn((args.batch, cfg.frontend_tokens,
                                  cfg.d_model), generator=ge, device=device)
    loop = ServeLoop(params, cfg, max_seq=max_seq, dispatch=dispatch,
                     two_phase=two_phase, temperature=args.temperature,
                     pipeline_depth=args.pipeline_depth, attn_mask=attn_mask,
                     quantize_experts=args.quantize_experts,
                     kv_quant=args.kv_quant, device=device)
    gen = loop.run(prompts, args.gen, embeddings=emb)
    s = loop.summary()

    print(f"prefill: {s['prefill']['seconds'] * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len}"
          + (f" after {cfg.frontend_tokens} {cfg.frontend} embedding "
             "positions" if emb is not None else ""))
    dec = s.get("decode", {"seconds": 0.0, "calls": 0})  # --gen 1: no steps
    print(f"decode:  {dec['seconds'] * 1e3:.1f} ms for {dec['calls']} steps "
          f"({dec.get('tok_per_s', 0.0):.1f} tok/s)"
          + (" [two-phase]" if loop.two_phase else
             f" [fused, capture {s['capture']['ms']:.1f} ms]"))
    for phase in ("route", "execute"):
        if phase in s:
            print(f"{phase}:   {s[phase]['seconds'] * 1e3:.1f} ms over "
                  f"{s[phase]['calls']} layer calls (within prefill+decode)")
    if args.pipeline_depth:
        drain = s.get("drain", {"seconds": 0.0})["seconds"]
        print(f"pipeline depth 1: drain {drain * 1e3:.1f} ms; timing "
              + ", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in s["timing"].items()))
    if "stream" in s:
        st = s["stream"]
        print(f"stream:  nnzb {st['nnzb_stream_mean']:.1f} (bucketed) vs "
              f"{st['grid_nnzb']} full-grid blocks")
    if attn_mask is not None:
        print(f"attn mask: {args.attn_mask} ({args.attn_mask_impl}), "
              f"{s['timing']['attention_ref_fallbacks']} oracle fallbacks")
    print("sample generations (token ids):")
    for b in range(min(args.batch, 2)):
        print(f"  [{b}] {gen[b, :16].tolist()}")
    return gen


def _main_continuous(args, cfg, params, max_seq, dispatch, two_phase,
                     attn_mask, device) -> Dict[int, np.ndarray]:
    """``--continuous``: ``--requests`` synthetic requests (prompt lengths
    uniform in [prompt_len / 2, prompt_len], budgets in [gen / 2, gen], from
    numpy seed 0), all queued at once, through a ``ServeScheduler`` of
    ``--slots`` slots in the ``--two-phase`` mode; prints the summary and
    returns {uid: tokens}."""
    rng = np.random.default_rng(0)
    sched = ServeScheduler(params, cfg, max_seq=max_seq,
                           max_slots=args.slots, dispatch=dispatch,
                           two_phase=two_phase, temperature=args.temperature,
                           pipeline_depth=args.pipeline_depth,
                           attn_mask=attn_mask,
                           quantize_experts=args.quantize_experts,
                           kv_quant=args.kv_quant, device=device)
    for _ in range(args.requests):
        plen = int(rng.integers(max(2, args.prompt_len // 2),
                                args.prompt_len + 1))
        sched.submit(rng.integers(0, cfg.vocab_size, plen),
                     int(rng.integers(max(2, args.gen // 2), args.gen + 1)))
    gen = sched.run()
    s = sched.summary()
    dec = s.get("decode", {})
    print(f"served {len(gen)} requests in {sched.step_idx} steps "
          f"({dec.get('tok_per_s', 0.0):.1f} decode tok/s)"
          + (" [two-phase]" if sched.two_phase else
             f" [fused, capture {s['capture']['ms']:.1f} ms]"))
    lat, first = s["token_latency_ms"], s["first_token_ms"]
    print(f"per-token latency: p50 {lat['p50']:.1f} ms, p99 "
          f"{lat['p99']:.1f} ms over {lat['n']} tokens; first token p50 "
          f"{first['p50']:.1f} ms, p99 {first['p99']:.1f} ms")
    print(f"batch buckets: {s['batch_buckets']}"
          + (f"; nnzb buckets: {s['nnzb_buckets']}" if sched.two_phase
             else ""))
    if args.pipeline_depth:
        tm = s["timing"]
        print(f"overlap: {tm['route_hidden_ms']:.1f} ms of route hidden "
              f"behind an execute in flight "
              f"({100 * tm['route_hidden_frac']:.0f}% of route)")
    for uid in sorted(gen)[:2]:
        print(f"  [{uid}] {gen[uid][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
