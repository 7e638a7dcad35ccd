"""Serving launcher of the port: the static-batch ``ServeLoop``.

One prefill over a fixed (B, S) prompt batch, then lockstep one-token
decode steps, layer by layer (``model.prefill_layered`` /
``model.decode_step_layered``).  With the ``"bcsr"`` dispatch backend on an
MoE arch the loop is **two-phase**: at every attn+moe layer it routes on the
host (``moe.route_moe``: router, slot cumsums, routed-stream compaction to a
bucketed :class:`BatchedBCSR`) and then executes (``moe.execute_moe``: the
SpMM kernel's dispatch, expert FFN, combine).  With ``"gather"`` every
attn+moe layer is one ``moe.apply_moe`` call.  Both give the same tokens.
A stack without attn+moe layers (rwkv6-7b: ``rwkv`` blocks, whose prefill
runs the WKV kernel K7) takes the single-phase path whatever the backend.

``pipeline_depth`` (default 0):

* ``0`` -- fully serial: each phase waits for the device
  (``torch.cuda.synchronize``) before reading the clock, and the route
  clock starts only after the attention half has drained, so queued device
  work is never charged to routing.
* ``1`` -- pipelined: each attn+moe layer's route phase 1 is dispatched with
  its attention half (``route_ahead``), so the host fetches only the small
  slot stream; the dispatched execute stays in flight
  (``engine.StreamPipeline``) behind the next layer's host route; the
  sampled token feeds the next step's embedding on the device.  Decode makes
  no per-step host sync beyond the slot fetches, and one drain ends it.
  Tokens equal depth 0's at any temperature, on both backends;
  ``summary()["timing"]`` says how much route time the overlap hid
  (``route_hidden_frac``).

``attn_mask`` (an ``AttnMaskSpec``) sends every prefill attention layer it
applies to through the masked flash kernels (K4s stream walk or K4m masked
grid); decode is untouched.  Not ported yet: the continuous-batching
``ServeScheduler``, resilience hooks and quantized experts / KV cache.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --dispatch bcsr --gen 8 \
      --attn-mask local_global --attn-mask-impl sparse --pipeline-depth 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.masks import AttnMaskSpec
from repro_torch.kernels import engine
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import model as M
from repro_torch.models import moe


@dataclasses.dataclass
class StepStat:
    """One timed phase of the loop; ``extra`` carries phase-specific detail
    (e.g. the route phase's nnzb stream accounting)."""
    phase: str          # prefill | route | execute | decode | drain
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


def _check_on(tree, device: torch.device) -> None:
    """Every tensor of a param tree lies on ``device`` (its type)."""
    if isinstance(tree, dict):
        tree = tree.values()
    elif isinstance(tree, torch.Tensor):
        if tree.device.type != device.type:
            raise ValueError(f"ServeLoop: a param on {tree.device}, loop on "
                             f"{device}")
        return
    for leaf in tree:
        _check_on(leaf, device)


class ServeLoop:
    """Batched greedy/temperature serving loop with KV caches.

    Parameters
    ----------
    params, cfg : the model (every param on ``device``).
    max_seq : decode-cache capacity (prompt + generation).
    dispatch : MoE dispatch backend ("gather" | "bcsr"); default is the
        config's ``moe_dispatch``.  "bcsr" on an MoE arch runs two-phase.
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
    device : where the loop runs; "cuda" (default) raises without a GPU.
    """

    def __init__(self, params, cfg, *, max_seq: int,
                 dispatch: Optional[str] = None, temperature: float = 0.0,
                 sample_seed: int = 3, pipeline_depth: int = 0,
                 attn_mask: Optional[AttnMaskSpec] = None, device="cuda"):
        self.device = resolve_device(device)
        _check_on(params, self.device)
        M._check_kinds(cfg)
        self.params, self.cfg = params, cfg
        self.max_seq = max_seq
        self.backend = dispatch or cfg.moe_dispatch
        if self.backend not in ("gather", "bcsr"):
            raise ValueError(f"unknown moe_dispatch backend {self.backend!r}")
        self.two_phase = (self.backend == "bcsr"
                          and "attn+moe" in cfg.block_unit)
        self.temperature = temperature
        self.attn_mask = attn_mask
        self._pipe = engine.StreamPipeline(pipeline_depth)
        self.pipeline_depth = pipeline_depth
        # oracle fallbacks are counted from this loop's own baseline
        self._fallback_base = flash_ops.fallback_count()
        self._sample_seed = sample_seed
        self._gen = torch.Generator(device=self.device)
        self.stats: List[StepStat] = []
        self.cache = None
        self.pos: Optional[int] = None
        self.generated: List[torch.Tensor] = []

    # ------------------------------------------------------------- phases --

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _moe_fn(self):
        if self.two_phase:
            return self._moe_two_phase
        return functools.partial(moe.apply_moe, dispatch=self.backend)

    def _route_ahead(self) -> bool:
        return self.two_phase and self.pipeline_depth > 0

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
        entry, else 0 (always 0 at depth 0)."""
        step = len(self.generated) - 1
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
        t0 = time.monotonic()
        out, new_counts = moe.execute_moe(p_ffn, h, plan, cfg)
        # depth 0: waits the execute out; depth 1: leaves it in flight
        self._pipe.push(plan, out)
        self.stats.append(StepStat(
            "execute", step, time.monotonic() - t0,
            tokens=h.shape[0] * h.shape[1],
            extra={"nnzb_stream": info.get("nnzb_stream"),
                   "dispatch_only": pipelined}))
        return out, new_counts

    def prefill(self, prompts) -> torch.Tensor:
        """Run the prompts (B, S) through the model, fill the decode cache,
        and emit the first generated token (B, 1).  Ends with the device
        drained at either depth."""
        prompts = torch.as_tensor(prompts, device=self.device)
        self.generated = []
        t0 = time.monotonic()
        logits, cache, pos = M.prefill_layered(
            self.params, prompts, self.cfg, max_seq=self.max_seq,
            moe_fn=self._moe_fn(), attn_mask=self.attn_mask,
            route_ahead=self._route_ahead())
        self._sync()
        self._pipe.drain()
        self.stats.append(StepStat("prefill", -1, time.monotonic() - t0,
                                   tokens=prompts.numel()))
        self.cache, self.pos = cache, pos
        nxt = self._sample(logits[:, -1])
        self.generated = [nxt]
        return nxt

    def _sample(self, last_logits: torch.Tensor) -> torch.Tensor:
        return sample_tokens(last_logits, self.cfg.vocab_size,
                             self.temperature, self._gen)

    def decode_step(self) -> torch.Tensor:
        """Generate one token for every sequence in the batch.  At depth 1
        the step is only dispatched (its stat ``dispatch_only``): the
        sampled token stays on the device and feeds the next step."""
        if self.cache is None:
            raise RuntimeError("decode_step before prefill")
        step = len(self.generated) - 1
        pos = self.pos + step
        if pos >= self.max_seq:
            raise RuntimeError(
                f"ServeLoop.decode_step: KV-cache overflow -- decode write "
                f"position {pos} >= max_seq {self.max_seq}. Raise max_seq or "
                f"generate fewer tokens.")
        tok = self.generated[-1]
        t0 = time.monotonic()
        logits, self.cache = M.decode_step_layered(
            self.params, self.cfg, self.cache, pos, tok,
            moe_fn=self._moe_fn(), route_ahead=self._route_ahead())
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

    def run(self, prompts, gen: int) -> np.ndarray:
        """prefill + (gen - 1) decode steps; returns (B, gen) token ids.
        Every run starts from a fresh sampling generator, so seeded runs
        with ``temperature > 0`` are reproducible.  An exception mid-run
        releases every in-flight execute before it propagates."""
        self.stats.clear()
        self._fallback_base = flash_ops.fallback_count()
        self._pipe.drain()
        self._gen.manual_seed(self._sample_seed)
        try:
            self.prefill(prompts)
            self.decode(gen - 1)
        except BaseException:
            self._pipe.abort()
            raise
        return torch.cat(self.generated, dim=1).cpu().numpy()

    def summary(self) -> Dict[str, Any]:
        """Per-phase seconds and calls of the last :meth:`run`.  The phases
        are not disjoint: "prefill" and each "decode" step time the whole
        layered pass, inclusive of the "route" / "execute" layer calls made
        inside it; at depth 1 the decode steps are dispatch walls and the
        "drain" stat is the device's wait, so ``decode.tok_per_s`` is batch
        x steps / (decode + drain seconds).  ``stream`` is the routed-stream
        accounting of two-phase mode.  ``timing`` splits the route phase
        into ``host_route_ms`` (route minus its slot-fetch wait) and
        ``route_wait_ms``, gives the attention drains before the routes
        (``attn_drain_ms``, depth 0), the waited execute walls
        (``device_execute_ms``, depth 0) and the dispatch-only ones
        (``execute_dispatch_ms``, depth 1), the route time hidden behind an
        execute in flight (``route_hidden_ms``, and its share of the route
        phase ``route_hidden_frac``, 0 at depth 0), and the run's attention
        oracle fallbacks (``attention_ref_fallbacks``, ``attn_mask`` with
        ``impl="ref"``)."""
        out: Dict[str, Any] = {}
        for phase in ("prefill", "route", "execute", "decode", "drain"):
            ss = [s for s in self.stats if s.phase == phase]
            if ss:
                out[phase] = {"seconds": sum(s.seconds for s in ss),
                              "calls": len(ss)}
        dec = out.get("decode")
        if dec:
            wall = dec["seconds"] + out.get("drain", {}).get("seconds", 0.0)
            if wall > 0:
                batch = self.generated[0].shape[0]
                dec["tok_per_s"] = batch * dec["calls"] / wall
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
    ap.add_argument("--pipeline-depth", type=int, choices=[0, 1], default=0,
                    help="0 = serial; 1 = route phase 1 with the attention "
                         "half, executes in flight behind the next host "
                         "route, no per-step host sync (the same tokens)")
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
    max_seq = args.prompt_len + args.gen
    g = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=g, device=device)
    loop = ServeLoop(params, cfg, max_seq=max_seq,
                     dispatch=None if args.dispatch == "config"
                     else args.dispatch,
                     temperature=args.temperature,
                     pipeline_depth=args.pipeline_depth, attn_mask=attn_mask,
                     device=device)
    gen = loop.run(prompts, args.gen)
    s = loop.summary()

    print(f"prefill: {s['prefill']['seconds'] * 1e3:.1f} ms for "
          f"{args.batch}x{args.prompt_len}")
    dec = s.get("decode", {"seconds": 0.0, "calls": 0})  # --gen 1: no steps
    print(f"decode:  {dec['seconds'] * 1e3:.1f} ms for {dec['calls']} steps "
          f"({dec.get('tok_per_s', 0.0):.1f} tok/s)"
          + (" [two-phase]" if loop.two_phase else ""))
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


if __name__ == "__main__":
    main()
