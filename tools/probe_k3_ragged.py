"""Which side moves in chip_smoke's ragged f32 K3 check?

``chip_smoke.py`` holds K3 through ``ops.attention`` on the card (S = 200 of
a 256-row draw, causal and not, 32 x 32 tiles, f32, within 1e-5 of the
largest value) against its plain version on the card, and prints how far
the host CPU's plain version lies from an f64 oracle: on some hosts that
product drifted 100x further than the kernel.  This script repeats the
host's and the card's side on the same seeded inputs and reports, for each
side, how many distinct results it gives and how far each is from the f64
oracle of ``chip_smoke._attention_f64``:

* the card: ``--card-reps`` calls, with the caching allocator's addresses
  shuffled between calls;
* the host CPU: ``--host-reps`` calls at each thread count of
  ``--threads``, with the inputs copied to buffers of every 4-byte offset
  (0..15 words) so that the CPU BLAS sees each alignment;
* chip_smoke's whole ``phase_attention_vs_plain`` ``--phase-reps`` times,
  counting the runs whose checks fail.

Run from the repository root on a machine with one GPU:

    python3 tools/probe_k3_ragged.py [--card-reps 300] [--host-reps 8]

It prints one JSON object as its last line and writes the same to
``chiprun_out/k3_probe.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    """chip_smoke's first flash draw: f32, B=2, heads 4/2, S=256, D=64,
    cut to S=200."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    B, Hq, Hkv, S, D = 2, 4, 2, 256, 64
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    Sr = S - 56
    return tuple(x[:, :, :Sr].contiguous() for x in (q, k, v))


def _at_offset(x, words: int):
    """A copy of ``x`` that starts ``words`` f32 words into a fresh buffer."""
    import torch
    buf = torch.empty(x.numel() + 16, dtype=x.dtype)
    out = buf[words:words + x.numel()].view(x.shape)
    out.copy_(x)
    return out


def _distinct(outs):
    import torch
    kinds = []
    for o in outs:
        if not any(torch.equal(o, k) for k in kinds):
            kinds.append(o)
    return kinds


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--card-reps", type=int, default=300)
    p.add_argument("--host-reps", type=int, default=8)
    p.add_argument("--threads", default="1,2,8")
    p.add_argument("--phase-reps", type=int, default=10)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_k3_ragged: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    build.build_all(["flash_attention"])
    chip_smoke.phase_card()
    cpu0 = torch.get_num_threads()
    qh, kh, vh = _inputs()
    qc, kc, vc = (x.cuda() for x in (qh, kh, vh))
    report = {"host_threads_default": cpu0, "cases": []}
    for causal in (True, False):
        kw = dict(causal=causal, bq=32, bk=32)
        exact = chip_smoke._attention_f64(qh, kh, vh, causal)
        big = exact.abs().max().item()

        def err(o):
            return (o.cpu().double() - exact).abs().max().item()

        card = []
        for i in range(args.card_reps):
            junk = torch.empty(1 + (i * 7919) % 65536, device="cuda")
            card.append(ops.attention(qc, kc, vc, **kw).cpu())
            del junk
        torch.cuda.synchronize()
        card_kinds = _distinct(card)
        host = {}
        for t in (int(x) for x in args.threads.split(",")):
            torch.set_num_threads(t)
            outs = []
            for _ in range(args.host_reps):
                for off in range(16):
                    outs.append(ops.attention(
                        *(_at_offset(x, off) for x in (qh, kh, vh)), **kw))
            kinds = _distinct(outs)
            host[t] = {"runs": len(outs), "distinct": len(kinds),
                       "err_vs_f64": [err(o) for o in kinds],
                       "vs_card": [(o - card[0]).abs().max().item()
                                   for o in kinds]}
        torch.set_num_threads(cpu0)
        case = {"causal": causal, "tolerance": chip_smoke.tolerance(
                    card[0].abs().max().item(), torch.float32),
                "largest": big,
                "card": {"runs": len(card), "distinct": len(card_kinds),
                         "err_vs_f64": [err(o) for o in card_kinds]},
                "host": host}
        report["cases"].append(case)
        print(json.dumps(case), flush=True)
    failures = []
    t0 = time.monotonic()
    for i in range(args.phase_reps):
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                chip_smoke.phase_attention_vs_plain()
        except RuntimeError as e:
            failures.append(str(e))
    report["phase_attention_vs_plain"] = {
        "runs": args.phase_reps, "failures": failures,
        "seconds": time.monotonic() - t0}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k3_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
