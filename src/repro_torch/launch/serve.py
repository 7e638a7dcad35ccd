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

Every phase is serial (``pipeline_depth=0`` of the reference): each phase
waits for the device (``torch.cuda.synchronize``) before reading the clock,
and the route clock starts only after the attention half has drained, so
queued device work is never charged to routing.  ``attn_mask`` (an
``AttnMaskSpec``) sends every prefill attention layer it applies to through
the masked flash kernels (K4s stream walk or K4m masked grid); decode is
untouched.  Not ported yet: the pipelined depth 1, the continuous-batching
``ServeScheduler``, resilience hooks and quantized experts / KV cache.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama4-scout-17b-a16e --smoke --dispatch bcsr --gen 8 \
      --attn-mask local_global --attn-mask-impl sparse
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
    phase: str          # prefill | route | execute | decode
    step: int           # decode step index (-1 for prefill)
    seconds: float
    tokens: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class ServeLoop:
    """Batched greedy/temperature serving loop with KV caches.

    Parameters
    ----------
    params, cfg : the model (params on ``device``).
    max_seq : decode-cache capacity (prompt + generation).
    dispatch : MoE dispatch backend ("gather" | "bcsr"); default is the
        config's ``moe_dispatch``.  "bcsr" on an MoE arch runs two-phase.
    temperature : 0 = greedy argmax, > 0 = sampling from
        ``softmax(logits / temperature)`` with a ``torch.Generator``
        reseeded from ``sample_seed`` at every :meth:`run`.
    attn_mask : an ``AttnMaskSpec`` for prefill attention (``impl``
        "sparse" | "dense" | "ref"), or None.
    device : where the loop runs; "cuda" (default) raises without a GPU.
    """

    def __init__(self, params, cfg, *, max_seq: int,
                 dispatch: Optional[str] = None, temperature: float = 0.0,
                 sample_seed: int = 3,
                 attn_mask: Optional[AttnMaskSpec] = None, device="cuda"):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"ServeLoop: params on {params['embed'].device}, "
                             f"loop on {self.device}")
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
        # oracle fallbacks are counted from this loop's own baseline
        self._fallback_base = flash_ops.fallback_count()
        self._sample_seed = sample_seed
        self._gen = torch.Generator(device=self.device)
        self._pipe = engine.StreamPipeline(0)
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

    def _moe_two_phase(self, p_ffn, h, cfg, counts=None, pos=None):
        """The route -> execute stage injected at every attn+moe layer.
        ``h`` is drained BEFORE the route clock starts (the attention half
        is queued device work, not routing), and the execute result is
        waited for, so every phase wall is honest device time."""
        step = len(self.generated) - 1
        t_d = time.monotonic()
        self._sync()
        drain_s = time.monotonic() - t_d
        t0 = time.monotonic()
        plan, info = moe.route_moe(p_ffn, h, cfg, counts=counts, pos=pos,
                                   dispatch=self.backend)
        self.stats.append(StepStat(
            "route", step, time.monotonic() - t0,
            tokens=h.shape[0] * h.shape[1],
            extra={**info, "drain_s": drain_s}))
        t0 = time.monotonic()
        out, new_counts = moe.execute_moe(p_ffn, h, plan, cfg)
        self._pipe.push(plan, out)   # depth 0: waits the execute out
        self.stats.append(StepStat(
            "execute", step, time.monotonic() - t0,
            tokens=h.shape[0] * h.shape[1],
            extra={"nnzb_stream": info.get("nnzb_stream")}))
        return out, new_counts

    def prefill(self, prompts) -> torch.Tensor:
        """Run the prompts (B, S) through the model, fill the decode cache,
        and emit the first generated token (B, 1)."""
        prompts = torch.as_tensor(prompts, device=self.device)
        self.generated = []
        t0 = time.monotonic()
        logits, cache, pos = M.prefill_layered(
            self.params, prompts, self.cfg, max_seq=self.max_seq,
            moe_fn=self._moe_fn(), attn_mask=self.attn_mask)
        self._sync()
        self._pipe.drain()
        self.stats.append(StepStat("prefill", -1, time.monotonic() - t0,
                                   tokens=prompts.numel()))
        self.cache, self.pos = cache, pos
        nxt = self._sample(logits[:, -1])
        self.generated = [nxt]
        return nxt

    def _sample(self, last_logits: torch.Tensor) -> torch.Tensor:
        lg = last_logits[:, : self.cfg.vocab_size]
        if self.temperature > 0:
            probs = torch.softmax(lg / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(lg, dim=-1)
        return nxt[:, None].to(torch.int32)

    def decode_step(self) -> torch.Tensor:
        """Generate one token for every sequence in the batch."""
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
            moe_fn=self._moe_fn())
        self._sync()
        self.stats.append(StepStat("decode", step, time.monotonic() - t0,
                                   tokens=tok.shape[0]))
        nxt = self._sample(logits[:, -1])
        self.generated.append(nxt)
        return nxt

    def decode(self, n: int) -> None:
        for _ in range(n):
            self.decode_step()

    # -------------------------------------------------------------- drive --

    def run(self, prompts, gen: int) -> np.ndarray:
        """prefill + (gen - 1) decode steps; returns (B, gen) token ids.
        Every run starts from a fresh sampling generator, so seeded runs
        with ``temperature > 0`` are reproducible."""
        self.stats.clear()
        self._fallback_base = flash_ops.fallback_count()
        self._gen.manual_seed(self._sample_seed)
        self.prefill(prompts)
        self.decode(gen - 1)
        return torch.cat(self.generated, dim=1).cpu().numpy()

    def summary(self) -> Dict[str, Any]:
        """Per-phase seconds and calls of the last :meth:`run`.  The phases
        are not disjoint: "prefill" and each "decode" step time the whole
        layered pass, inclusive of the "route" / "execute" layer calls made
        inside it.  ``decode.tok_per_s`` is batch x steps / decode seconds;
        ``stream`` is the routed-stream accounting of two-phase mode;
        ``timing["attention_ref_fallbacks"]`` counts the attention oracle
        fallbacks of the run (``attn_mask`` with ``impl="ref"``)."""
        out: Dict[str, Any] = {}
        for phase in ("prefill", "route", "execute", "decode"):
            ss = [s for s in self.stats if s.phase == phase]
            if ss:
                out[phase] = {"seconds": sum(s.seconds for s in ss),
                              "calls": len(ss)}
        dec = out.get("decode")
        if dec and dec["seconds"] > 0:
            batch = self.generated[0].shape[0]
            dec["tok_per_s"] = batch * dec["calls"] / dec["seconds"]
        streams = [s for s in self.stats
                   if s.phase == "route" and "nnzb_stream" in s.extra]
        if streams:
            out["stream"] = {
                "nnzb_stream_mean": float(np.mean(
                    [s.extra["nnzb_stream"] for s in streams])),
                "nnzb_routed_mean": float(np.mean(
                    [s.extra["nnzb_routed"] for s in streams])),
                "grid_nnzb": streams[-1].extra["grid_nnzb"],
            }
        out["timing"] = {"attention_ref_fallbacks":
                         flash_ops.fallback_count() - self._fallback_base}
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
                     temperature=args.temperature, attn_mask=attn_mask,
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
