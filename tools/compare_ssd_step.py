"""Time M1 (``kernels/ssd/csrc/ssd_step.cu``, the one-token Mamba-2 SSD step)
beside its bound and the plain step, in one run.

The cases are zamba2-1.2b's decode step at (hd, ns) = (64, 64) with its 64
SSM heads, f32, inputs made on the card from one seed: B 1, 4 (the 4 x 2048
serving step) and 8 (the scheduler's top bucket), and B 64 (a large
batch, past one wave of blocks).  For each, the kernel in place (``out=``
the state, as the decode step writes its cache) and the plain step
(``ref.ssd_step_plain``: ``torch.einsum`` and the elementwise passes) run
in the order kernel, plain, plain, kernel, each timed by CUDA events over
back-to-back calls and again replayed from a CUDA graph (device time
without the host's launch); beside them the bound: x, e, B, C and the
state read once, y and the state written once, at 3.35 TB/s.  The kernel
must be ``torch.equal`` to ``ref.ssd_step_ordered`` and its state to the
plain step's: exit 1 otherwise.

Run from the repository root on a machine with one GPU:

    python3 tools/compare_ssd_step.py [--iters 50]

Each case prints one JSON line; the whole result is the last line and
``chiprun_out/compare_ssd_step.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 35
HEADS, HD, NS = 64, 64, 64
BATCHES = (1, 4, 8, 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_ssd_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel as mk
    from repro_torch.kernels.ssd import ops
    from repro_torch.kernels.ssd import ref
    card = cs.smi("name,power.limit")
    print(card)
    log = build.build_all(["ssd_step"])["ssd_step"]["log"]
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS),
              "resources": cs.kernel_resources(log) if log else [],
              "cases": []}
    for kern, used, spills in result["resources"]:
        print(f"{kern}: {used}; {spills}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for B in BATCHES:
        a = cs._ssd_inputs(g, B, HEADS, HD, NS)
        y, h = mk.ssd_step(*a)
        oy, oh = ref.ssd_step_ordered(*a)
        _, ph = ref.ssd_step_plain(*a)
        st = a[4].clone()
        runs = {"kernel": lambda: mk.ssd_step(*a[:4], st, out=st),
                "plain": lambda: ref.ssd_step_plain(*a)}
        case = {"B": B, "heads": HEADS, "hd": HD, "ns": NS,
                "equal_ordered": bool(torch.equal(y, oy)
                                      and torch.equal(h, oh)),
                "state_equal_plain": bool(torch.equal(h, ph)),
                "ms": {k: [] for k in runs}, "graph_ms": {k: [] for k in runs}}
        clocks = [cs.smi("clocks.sm")]
        for label in ("kernel", "plain", "plain", "kernel"):
            case["ms"][label].append(cs.time_ms(runs[label], args.iters))
        for label in ("kernel", "plain", "plain", "kernel"):
            case["graph_ms"][label].append(cs.graph_ms(runs[label]))
        clocks.append(cs.smi("clocks.sm"))
        case.update(sm_clocks=clocks,
                    bytes_bound_ms=ops.state_bytes(B, HEADS, HD, NS)
                    / cs.HBM_BYTES_PER_S * 1e3)
        result["cases"].append(case)
        print(json.dumps(case))
        del a, y, h, oy, oh, ph, st
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(c["equal_ordered"] and c["state_equal_plain"]
                              for c in result["cases"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_ssd_step.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
