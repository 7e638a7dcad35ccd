"""Time M1 (``kernels/ssd/csrc/ssd_step.cu``, a Mamba-2 layer's decode step from the conv's output to the gated norm's input) beside its bound, the plain segment and other builds of it, in one run.

Each extra argument is the path of another ``ssd_step.cu``, for example
the one before this design (the card's copy has no ``.git``, so make it
first):

    git show HEAD~1:src/repro_torch/kernels/ssd/csrc/ssd_step.cu > build/ssd_step_prev.cu
    python3 tools/compare_ssd_step.py build/ssd_step_prev.cu

A source whose ``ssd_step_launch`` takes the SSD recurrence alone (x, e,
b, c, h0, y, h1: the interface before M1 took the whole step) is timed as
the decode segment it served, as ``apply_mamba`` ran it: the 18 PyTorch
passes around it (softplus of dt + dt_bias, the decay, x dt and the casts
of B and C before; the skip, the cast and the gate after) and its launch.
A source with the in-tree interface is timed as its kernel alone.

The cases are zamba2-1.2b's decode step at (hd, ns) = (64, 64) with its 64
SSM heads, bf16 (the served compute dtype), inputs made on the card from
one seed as ``chip_smoke._ssd_inputs`` makes them (the rows views of a
conv output and a projection): B 1, 4 (the 4 x 2048 serving step), 8
(the scheduler's top bucket) and 64 (past one wave of blocks).  For each,
every build steps a state in place (as the decode step writes its cache),
in the order others, in-tree, in-tree, others reversed, each timed by
CUDA events over back-to-back calls and again replayed from a CUDA graph
(device time without the host's launches); after them the plain segment
(``ref.mamba_step_plain``) the same two ways; beside them the bytes bound (the
state read and written once, the rows and the layer's vectors read once,
the output written once, at 3.35 TB/s).  The in-tree kernel's output must
be ``torch.equal`` to ``ref.mamba_step_ordered``'s and its state to
``ref.mamba_step_plain``'s, and every other build's output and state
``torch.equal`` to the in-tree kernel's: exit 1 otherwise.

Run from the repository root on a machine with one GPU:

    python3 tools/compare_ssd_step.py [OTHER.cu ...] [--iters 50]

Each case prints one JSON line; the whole result is the last line and
``chiprun_out/compare_ssd_step.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import compare_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 36
HEADS, HD, NS = 64, 64, 64
BATCHES = (1, 4, 8, 64)


def _bind(lib, text):
    """A build of ``ssd_step.cu`` bound: (library, takes the whole step),
    the earlier launcher taking the SSD recurrence alone."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launcher = text[text.index("int ssd_step_launch("):]
    n = launcher[:launcher.index(")")].count(",") + 1
    if n not in (12, 22):
        raise SystemExit(f"ssd_step_launch with {n} parameters: not an "
                         "interface this tool knows")
    whole = n == 22
    lib.ssd_step_launch.argtypes = ([P] * 11 + [I] * 4 + [L] * 5 + [I] + [P]
                                    if whole else [P] * 7 + [I] * 4 + [P])
    lib.ssd_step_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, whole


def _segment(lib, whole, a, st):
    """One decode step's M1 segment on a build, stepping ``st`` in place:
    its kernel on ``a`` (the whole step's arguments) for a build of the
    in-tree interface; else the passes around the earlier kernel, as
    ``apply_mamba`` ran them, and its launch.  Returns (output, state)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd import kernel as mk
    xs, b, c, z, dt, a_log, dt_bias, d_skip, _ = a
    B, d_in = xs.shape
    nh, ns = dt.shape[-1], b.shape[-1]
    hd = d_in // nh

    def whole_step():
        y = torch.empty((B, d_in), dtype=xs.dtype, device=xs.device)
        err = lib.ssd_step_launch(
            *(t.data_ptr() for t in (xs, b, c, z, dt, a_log, dt_bias, d_skip,
                                     st, y, st)),
            B, nh, hd, ns, *(t.stride(0) for t in (xs, b, c, z, dt)),
            mk.DTYPES[xs.dtype], torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "ssd_step launch")
        return y, st

    def segment():
        cd = xs.dtype
        dtp = F.softplus(dt.float() + dt_bias)
        decay = -torch.exp(a_log) * dtp
        xh = xs.float().reshape(B, nh, hd) * dtp[..., None]
        x, e, bf, cf = (t.float().contiguous()
                        for t in (xh, torch.exp(decay), b, c))
        y = torch.empty_like(x)
        err = lib.ssd_step_launch(
            *(t.data_ptr() for t in (x, e, bf, cf, st, y, st)), B, nh, hd,
            ns, torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "ssd_step launch")
        y = y + d_skip[:, None] * xs.float().reshape(B, nh, hd)
        y = y.reshape(B, d_in).to(cd)
        return y * F.silu(z), st

    return whole_step if whole else segment


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other ssd_step.cu sources")
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
    out_dir = os.path.join(ROOT, "build", "compare_ssd_step")
    os.makedirs(out_dir, exist_ok=True)
    log = build.build_all(["ssd_step"])["ssd_step"]["log"]
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS),
              "resources": {"in-tree": cs.kernel_resources(log)
                            if log else []},
              "cases": []}
    others = {}
    for src, ((lib, whole), res) in common.build_all(
            args.others, out_dir, _bind).items():
        others[src] = (lib, whole)
        result["resources"][src] = res
        result.setdefault("interface", {})[src] = (
            "whole step" if whole else "recurrence alone: timed as the "
            "parent's segment, its 18 passes and its kernel")
    for name, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{name}: {kern}: {used}; {spills}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for B in BATCHES:
        a = cs._ssd_inputs(g, B, HEADS, HD, NS, torch.bfloat16)
        y, h = mk.ssd_step(*a)
        oy, _ = ref.mamba_step_ordered(*a)
        _, ph = ref.mamba_step_plain(*a)
        case = {"B": B, "heads": HEADS, "hd": HD, "ns": NS,
                "dtype": "bfloat16",
                "equal_ordered": bool(torch.equal(y, oy)),
                "state_equal_plain": bool(torch.equal(h, ph)),
                "others_equal": {}}
        states = {"in-tree": a[8].clone()}
        runs = {"in-tree": lambda: mk.ssd_step(*a[:8], states["in-tree"],
                                               out=states["in-tree"])}
        for src, (lib, whole) in others.items():
            st = a[8].clone()
            oy2, oh2 = _segment(lib, whole, a, st)()
            case["others_equal"][src] = bool(torch.equal(oy2, y)
                                             and torch.equal(oh2, h))
            states[src] = a[8].clone()
            runs[src] = _segment(lib, whole, a, states[src])
        order = list(others) + ["in-tree", "in-tree"] \
            + list(reversed(others))
        runs["plain"] = lambda: ref.mamba_step_plain(*a)
        case["order"] = order + ["plain"]
        case["ms"] = {k: [] for k in runs}
        case["graph_ms"] = {k: [] for k in runs}
        clocks = [cs.smi("clocks.sm")]
        for label in case["order"]:
            case["ms"][label].append(cs.time_ms(runs[label], args.iters))
        for label in case["order"]:
            case["graph_ms"][label].append(cs.graph_ms(runs[label]))
        clocks.append(cs.smi("clocks.sm"))
        case.update(sm_clocks=clocks,
                    bytes_bound_ms=ops.state_bytes(B, HEADS, HD, NS, 2)
                    / cs.HBM_BYTES_PER_S * 1e3)
        result["cases"].append(case)
        print(json.dumps(case))
        del a, y, h, oy, ph, states, runs
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        c["equal_ordered"] and c["state_equal_plain"]
        and all(c["others_equal"].values()) for c in result["cases"])
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_ssd_step.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
