"""Continuous-batching serving benchmark of the port: a synthetic many-user
trace through ``launch.serve.ServeScheduler``, the counterpart of the
reference's ``benchmarks/bench_serve.py``, schema for schema.

What it records (in ``BENCH_torch_serve.json``), for each MoE dispatch
backend with the reference's ``two_phase`` default (gather fused, bcsr
two-phase):

* **tok/s** of the batched decode phase (emitted tokens / decode seconds)
  and the trace's wall time;
* **per-token latency p50/p99** (the wall time of the step or admission
  that emitted each token) and **first-token latency p50/p99** (submit to
  first token, queueing included);
* **the bucket law**, two-phase: the batch and nnzb buckets seen and
  ``compile_signatures`` (the distinct execute shapes; the port compiles
  nothing, so this is the count one captured graph a shape would need),
  bounded by ``signature_bound``;
* **serial-vs-pipelined A/B**: the same trace at ``pipeline_depth`` 0 (the
  top-level entry) and 1 (``pipelined``); the ``ab`` row holds both decode
  tok/s, both p50 / p99, the route time hidden behind an execute in flight
  and whether the two runs emitted the same tokens;
* **healthy-vs-faulty A/B** (``--fault-rate R`` > 0): the pipelined run
  again under ``FaultPlan.random(17, uids, R)``; the ``fault`` row holds
  the firings, finished / failed / shed / retries, the ladder and whether
  every surviving request emitted its healthy-run tokens.

Each run's entry also holds the port's own fields: ``capture`` (fused: the
graph captures, calls and ms), ``peak_gb`` (``max_memory_allocated`` on the
card, reset before the run; None on the CPU), ``launches`` (the kernels'
launch counts, set to 0 before the run) and, two-phase, ``execute_calls``.

Run modes (``--device`` defaults to ``cuda`` and raises without a GPU):
  python -m repro_torch.benchmarks.bench_serve                 # scout SMOKE
  python -m repro_torch.benchmarks.bench_serve --smoke         # TINY
  python -m repro_torch.benchmarks.bench_serve --fault-rate .3 # + fault row
  python -m repro_torch.benchmarks.bench_serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.benchmarks.common import emit_bench, row
from repro_torch.configs import get_smoke
from repro_torch.launch.serve import ServeScheduler
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.runtime import resilience as R

# tiny attn+moe config for --smoke: the reference's, field for field
TINY = ArchConfig(
    name="tiny-serve-bench", family="moe", d_model=32, n_heads=2,
    n_kv_heads=1, d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"),
    n_repeats=2, head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")


def synth_trace(n_requests: int, *, prompt_lo: int, prompt_hi: int,
                gen_lo: int, gen_hi: int, vocab: int, arrival_every: int,
                seed: int = 0) -> List[Tuple[int, np.ndarray, int]]:
    """A deterministic many-user trace: ``n_requests`` requests with
    uniformly mixed prompt/generation lengths from ``default_rng(seed)``,
    arriving in pairs every ``arrival_every`` scheduler steps.  Returns
    (arrival_step, prompt, max_new) tuples sorted by arrival; the same
    arrays as the reference's for the same arguments."""
    rng = np.random.default_rng(seed)
    trace = []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lo, prompt_hi + 1))
        gen = int(rng.integers(gen_lo, gen_hi + 1))
        prompt = rng.integers(0, vocab, plen).astype(np.int32)
        trace.append(((i // 2) * arrival_every, prompt, gen))
    return trace


def drive(sched: ServeScheduler,
          trace: List[Tuple[int, np.ndarray, int]]) -> dict:
    """Feed the trace into the scheduler at its arrival steps and run to
    drain; returns the scheduler summary + trace-level aggregates."""
    pending = sorted(trace, key=lambda t: t[0])
    t0 = time.monotonic()
    while pending or sched.has_work():
        while pending and pending[0][0] <= sched.step_idx:
            _, prompt, gen = pending.pop(0)
            sched.submit(prompt, gen)
        sched.step()
    wall = time.monotonic() - t0
    s = sched.summary()
    s["trace"] = {
        "requests": len(trace),
        "steps": sched.step_idx,
        "wall_seconds": wall,
        "prompt_tokens": int(sum(len(p) for _, p, _ in trace)),
        "generated_tokens": int(sum(len(r.tokens) for r in sched.finished)),
    }
    return s


def _measured(make, trace, device: torch.device):
    """A scheduler from ``make()`` driven over ``trace`` with the launch
    counts set to 0 and, on the card, the peak memory reset first.
    Returns (scheduler, summary, launches, peak GB or None)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    sched = make()
    kernels.reset_launches()
    s = drive(sched, trace)
    launches = {k: v for k, v in kernels.read_launches().items() if v}
    peak = (torch.cuda.max_memory_allocated(device) / 1e9
            if device.type == "cuda" else None)
    return sched, s, launches, peak


def run(*, smoke: bool = False, dispatch: Optional[str] = None,
        fault_rate: float = 0.0, cfg: Optional[ArchConfig] = None,
        params=None, trace_kw: Optional[dict] = None,
        max_seq: Optional[int] = None, slots: Optional[int] = None,
        seed: int = 0, device="cuda") -> dict:
    """The benchmark body.  The defaults are the reference's two modes:
    ``smoke`` (TINY, ``max_seq`` 24, 2 slots, 6 requests) or scout SMOKE
    (48, 4, 12 requests).  ``cfg``, ``params``, ``trace_kw``, ``max_seq``,
    ``slots`` and the trace's ``seed`` replace them (a full-width run on
    the card passes its own weights); ``params`` default to
    ``model.init_params(cfg, seed=0)`` on ``device``.  One scheduler is
    alive at a time: each is deleted (and collected) before the next."""
    device = resolve_device(device)
    if smoke:
        d_cfg, d_max_seq, d_slots = TINY, 24, 2
        d_trace = dict(n_requests=6, prompt_lo=4, prompt_hi=8, gen_lo=3,
                       gen_hi=6, arrival_every=2)
    else:
        d_cfg, d_max_seq, d_slots = get_smoke("llama4-scout-17b-a16e"), 48, 4
        d_trace = dict(n_requests=12, prompt_lo=8, prompt_hi=24, gen_lo=8,
                       gen_hi=16, arrival_every=3)
    cfg = cfg or d_cfg
    max_seq, slots = max_seq or d_max_seq, slots or d_slots
    trace_kw = {"vocab": cfg.vocab_size, **(trace_kw or d_trace),
                "seed": seed}
    if dispatch is not None:
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
    if params is None:
        params = M.init_params(cfg, seed=0, device=device)
    trace = synth_trace(**trace_kw)

    def scheduler(backend, depth, plan=None):
        return lambda: ServeScheduler(params, cfg, max_seq=max_seq,
                                      max_slots=slots, dispatch=backend,
                                      pipeline_depth=depth, fault_plan=plan,
                                      device=device)

    out = {"config": {"arch": cfg.name, "max_seq": max_seq, "slots": slots,
                      **{k: v for k, v in trace_kw.items() if k != "vocab"}},
           "device": str(device)}
    for backend in ("gather", "bcsr"):
        per_depth, tokens = {}, {}
        for depth, label in ((0, "serial"), (1, "pipelined")):
            sched, s, launches, peak = _measured(scheduler(backend, depth),
                                                 trace, device)
            entry = {
                "two_phase": sched.two_phase,
                "pipeline_depth": depth,
                "decode_tok_per_s": s.get("decode", {}).get("tok_per_s",
                                                            0.0),
                "token_latency_ms": s["token_latency_ms"],
                "first_token_ms": s["first_token_ms"],
                "batch_buckets": s["batch_buckets"],
                "trace": s["trace"],
                "requests_finished": s["requests"]["finished"],
                "timing": s.get("timing", {}),
                "capture": s.get("capture"),
                "peak_gb": peak,
                "launches": launches,
            }
            if sched.two_phase:
                # the bucket law: execute signatures are bounded by the
                # product of observed batch buckets, nnzb buckets, and token
                # shapes (decode S=1 + one per distinct prompt length)
                prompt_shapes = len({len(p) for _, p, _ in trace}) + 1
                entry.update(
                    nnzb_buckets=s["nnzb_buckets"],
                    compile_signatures=s["compile_signatures"],
                    signature_bound=(len(s["batch_buckets"]) + 1)
                    * max(1, len(s["nnzb_buckets"])) * prompt_shapes,
                    execute_calls=s.get("execute", {}).get("calls", 0))
            per_depth[label] = entry
            tokens[label] = {r.uid: list(map(int, r.tokens))
                             for r in sched.finished}
            del sched
        ser, pip = per_depth["serial"], per_depth["pipelined"]
        # the serial entry stays the backend's top-level schema; the
        # pipelined run and the A/B row ride under it
        e = dict(ser)
        e["pipelined"] = pip
        e["ab"] = {
            "serial_tok_per_s": ser["decode_tok_per_s"],
            "pipelined_tok_per_s": pip["decode_tok_per_s"],
            "decode_speedup": (pip["decode_tok_per_s"]
                               / ser["decode_tok_per_s"]
                               if ser["decode_tok_per_s"] else 0.0),
            "serial_p50_ms": ser["token_latency_ms"]["p50"],
            "pipelined_p50_ms": pip["token_latency_ms"]["p50"],
            "serial_p99_ms": ser["token_latency_ms"]["p99"],
            "pipelined_p99_ms": pip["token_latency_ms"]["p99"],
            "route_hidden_frac": pip["timing"].get("route_hidden_frac",
                                                   0.0),
            "tokens_match": tokens["serial"] == tokens["pipelined"],
        }
        e["tokens"] = tokens["serial"]
        if fault_rate > 0:
            # healthy-vs-faulty A/B: the same pipelined trace under a
            # seeded random fault plan -- survivors must emit the same
            # tokens as in the healthy run (per-request isolation)
            uids = list(range(trace_kw["n_requests"]))
            plan = R.FaultPlan.random(17, uids, fault_rate)
            sched, fs, launches, peak = _measured(
                scheduler(backend, 1, plan), trace, device)
            healthy = tokens["pipelined"]
            survivors = {r.uid: list(map(int, r.tokens))
                         for r in sched.finished}
            del sched
            fr = fs["requests"]
            e["fault"] = {
                "fault_rate": fault_rate,
                "faults_injected": len(plan.specs),
                "faults_triggered": len(plan.triggered),
                "healthy_tok_per_s": pip["decode_tok_per_s"],
                "faulty_tok_per_s": fs.get("decode", {}).get("tok_per_s",
                                                             0.0),
                "finished": fr["finished"],
                "failed": fr["failed"],
                "shed": fr["shed"],
                "retries": fr["retries"],
                "ladder": fs["health"]["ladder"],
                "survivor_tokens_match": all(
                    survivors[uid] == healthy[uid] for uid in survivors),
                "capture": fs.get("capture"),
                "peak_gb": peak,
                "launches": launches,
            }
        out[backend] = e
        gc.collect()
    return out


def rows(payload: dict) -> List[str]:
    """The reference's CSV rows of a :func:`run` payload."""
    out = []
    for backend in ("gather", "bcsr"):
        e = payload[backend]
        lat = e["token_latency_ms"]
        out.append(row(f"serve/{backend}/decode_tok_per_s",
                       e["decode_tok_per_s"], f"two_phase={e['two_phase']}"))
        out.append(row(f"serve/{backend}/token_latency_p50_ms", lat["p50"],
                       f"p99={lat['p99']:.1f};n={lat['n']}"))
        if "compile_signatures" in e:
            out.append(row(f"serve/{backend}/compile_signatures",
                           e["compile_signatures"],
                           f"bound={e['signature_bound']};"
                           f"batch_buckets={e['batch_buckets']};"
                           f"nnzb_buckets={e['nnzb_buckets']}"))
        ab = e["ab"]
        out.append(row(f"serve/{backend}/pipelined_tok_per_s",
                       ab["pipelined_tok_per_s"],
                       f"serial={ab['serial_tok_per_s']:.1f};"
                       f"speedup={ab['decode_speedup']:.2f}x;"
                       f"p50={ab['serial_p50_ms']:.1f}->"
                       f"{ab['pipelined_p50_ms']:.1f}ms;"
                       f"p99={ab['serial_p99_ms']:.1f}->"
                       f"{ab['pipelined_p99_ms']:.1f}ms;"
                       f"route_hidden={100 * ab['route_hidden_frac']:.0f}%;"
                       f"tokens_match={ab['tokens_match']}"))
        if "fault" in e:
            fl = e["fault"]
            out.append(row(f"serve/{backend}/faulty_tok_per_s",
                           fl["faulty_tok_per_s"],
                           f"healthy={fl['healthy_tok_per_s']:.1f};"
                           f"rate={fl['fault_rate']};"
                           f"triggered={fl['faults_triggered']}/"
                           f"{fl['faults_injected']};"
                           f"finished={fl['finished']};failed={fl['failed']};"
                           f"shed={fl['shed']};retries={fl['retries']};"
                           f"survivors_match={fl['survivor_tokens_match']}"))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dispatch", choices=["gather", "bcsr"], default=None)
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="re-run the pipelined trace under a seeded random "
                         "fault plan and emit a healthy-vs-faulty A/B row")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    payload = run(smoke=args.smoke, dispatch=args.dispatch,
                  fault_rate=args.fault_rate, device=device)
    for line in rows(payload):
        print(line)
    path = emit_bench("serve", payload, device=device)
    print(f"wrote {path}")
    return payload


if __name__ == "__main__":
    main()
