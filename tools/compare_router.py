"""Time R1 (``kernels/router/csrc/router.cu``) against other builds of it, in one run.

Each extra argument is the path of another ``router.cu``, for example the
one before this design (the card's copy has no ``.git``, so make it first):

    git show HEAD~1:src/repro_torch/kernels/router/csrc/router.cu > build/router_prev.cu
    git show HEAD~1:src/repro_torch/kernels/router/kernel.py > build/router_prev.py
    python3 tools/compare_router.py build/router_prev.cu --wrapper build/router_prev.py

A source whose ``router_launch`` takes no tile (the earlier interface: T,
d, E and the two dtypes) is called so; one that takes a tile runs at the
in-tree rule's tile (``tuning.router_tiles``).  ``--tiles S,TOKENS,EXPERTS
...`` also times the in-tree build at those tiles (``tuning.RouterTiles``:
``S`` 1 for the many-token kernel, 0 for the few-token one), at every
shape.  ``--wrapper PATH`` is another version of ``router/kernel.py``: its
``router_logits``, on the library of the first other source, is timed
eagerly and from a graph beside the in-tree wrapper, in the order other,
in-tree, in-tree, other, so that the wrappers' host costs compare.
``--ablate NAME...`` makes copies of the in-tree source with one part
removed under ``build/compare_router/`` (``nox``: no x staged or read,
every x 1; ``nomul``: each term an add alone; ``nostage``: no chunk
staged after the first ones) and times them the same way; they need not
agree.

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``, all at once, and each build's
registers and spills per kernel instance (``-Xptxas -v``) are printed.  The
cases, on inputs made on the card from one seed: T in {4, 8, 1024, 8192}
tokens (``--tokens``), d 5120, E 16 (llama4-scout's router), x bf16 and
f32, W f32.  The builds run in the order others, in-tree, in-tree, others
reversed, each timed by CUDA events over back-to-back launches and again
replayed from a CUDA graph (device time without the host's launch);
beside them the in-tree wrapper ``router_logits`` (eager minus graph: its
host cost), ``torch.matmul`` of x already in f32 by W (the yardstick) and
``x.float() @ w`` (information).  Every build's output (and every tile's)
must be ``torch.equal`` to ``router.ref.router_logits_ordered``: exit 1 if
any differs.  Each case prints one JSON line; the whole result is the last
line and ``chiprun_out/compare_router.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import compare_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS, D, E, SEED = (4, 8, 1024, 8192), 5120, 16, 26
HBM_BYTES_PER_S = 3.35e12
# --ablate: name -> ((text of the in-tree source, its replacement), ...)
ABLATE = {
    "nox": (("    stage_x(c, c % kStages);\n", ""),
            ("xc[t] = to_f(xr[t * kDC + kLaneStride * j]);", "xc[t] = 1.f;")),
    "nomul": (("return __fadd_rn(acc, __fmul_rn(x, w));",
               "return __fadd_rn(acc, w);"),),
    "nostage": (("    if (next < chunks) stage(next);\n", ""),),
}


def _bind(lib, text):
    """A build of ``router.cu`` bound: (library, takes a tile), the earlier
    launcher bound by hand."""
    from repro_torch.kernels.router import kernel
    tiled = "int staged" in text
    if tiled:
        kernel.bind(lib)
    else:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.router_launch.argtypes = [P] * 3 + [I] * 5 + [P]
        lib.router_launch.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [I]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, tiled


def _untiled(lib, x, w):
    """A launch of an earlier ``router.cu`` (no tile in its interface)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.router import kernel
    T, d = x.shape
    out = torch.empty((T, w.shape[1]), dtype=torch.float32, device="cuda")
    err = lib.router_launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), T, d,
                            w.shape[1], kernel._DTYPE_CODE[x.dtype],
                            kernel._DTYPE_CODE[w.dtype],
                            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "router launch")
    return out


def _mhz(clock: str) -> float:
    return float(clock.split()[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other router.cu sources")
    ap.add_argument("--ablate", nargs="*", default=[], choices=list(ABLATE),
                    help="ablation copies of the in-tree source to make, "
                    "build and time")
    ap.add_argument("--tiles", nargs="*", default=[],
                    help="tiles S,TOKENS,EXPERTS at which the in-tree build "
                    "is also timed")
    ap.add_argument("--wrapper", default=None,
                    help="another router/kernel.py, timed on the first "
                    "other source's build beside the in-tree wrapper")
    ap.add_argument("--tokens", type=int, nargs="*", default=list(TOKENS))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_router: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch.kernels import build, tuning
    from repro_torch.kernels.router import kernel
    from repro_torch.kernels.router.ref import router_logits_ordered
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS), "cases": [],
              "resources": {}, "d": D, "E": E}
    out_dir = os.path.join(ROOT, "build", "compare_router")
    os.makedirs(out_dir, exist_ok=True)
    log = build.build_all(["router"])["router"]["log"]
    if log:
        result["resources"]["in-tree"] = cs.kernel_resources(log)
    lib = kernel._lib()
    ablations = common.ablate("router", ABLATE, args.ablate, out_dir)
    others = {}
    for src, (bound, res) in common.build_all(args.others + ablations,
                                              out_dir, _bind).items():
        others[src], result["resources"][src] = bound, res
    for label, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{label} {kern}: {used}; {spills}")
    tiles = [tuning.RouterTiles(*(int(v) for v in t.split(",")))
             for t in args.tiles]
    if args.wrapper and not args.others:
        raise SystemExit("--wrapper needs another source to launch on")
    other_wrapper = (common.load_wrapper(
        args.wrapper, "_lib", others[args.others[0]][0], "router_logits")
        if args.wrapper else None)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device="cuda").manual_seed(SEED)
    w = torch.randn((D, E), generator=g, device="cuda") * D ** -0.5
    for T in args.tokens:
        for xn in ("bfloat16", "float32"):
            x = torch.randn((T, D), generator=g, device="cuda").to(
                getattr(torch, xn))
            want = router_logits_ordered(x, w)
            rule = tuning.router_tiles(T, E, sms)
            runs = {}
            for src, (olib, tiled) in others.items():
                runs[src] = ((lambda olib=olib: kernel.launch(olib, x, w,
                                                              rule))
                             if tiled else
                             (lambda olib=olib: _untiled(olib, x, w)))
            runs["in-tree"] = lambda: kernel.launch(lib, x, w, rule)
            for t in tiles:
                runs[",".join(map(str, t))] = (
                    lambda t=t: kernel.launch(lib, x, w, t))
            xf = x.float()
            wrappers = {"wrapper": lambda: kernel.router_logits(x, w)}
            if other_wrapper:
                wrappers[args.wrapper] = lambda: other_wrapper(x, w)
            extra = {"matmul_f32": lambda: torch.matmul(xf, w),
                     "float_then_matmul": lambda: x.float() @ w}
            case = {"T": T, "x_dtype": xn, "w_dtype": "float32",
                    "rule_tiles": list(rule), "builds": {}}
            for label, run in {**runs, **wrappers}.items():
                got = run()
                torch.cuda.synchronize()
                case["builds"][label] = {
                    "equal_ordered": bool(torch.equal(got, want)),
                    "ms": [], "graph_ms": []}
            order = list(others)
            tile_labels = [k for k in runs if k not in others
                           and k != "in-tree"]
            clocks = [cs.smi("clocks.sm")]
            for label in order + ["in-tree", "in-tree"] + order[::-1]:
                case["builds"][label]["ms"].append(
                    cs.time_ms(runs[label], args.iters))
            for label in order + ["in-tree", "in-tree"] + order[::-1]:
                case["builds"][label]["graph_ms"].append(
                    cs.graph_ms(runs[label]))
            worder = [k for k in wrappers if k != "wrapper"]
            for label in worder + ["wrapper", "wrapper"] + worder[::-1]:
                row = case["builds"][label]
                row["ms"].append(cs.time_ms(wrappers[label], args.iters))
            for label in worder + ["wrapper", "wrapper"] + worder[::-1]:
                row = case["builds"][label]
                row["graph_ms"].append(cs.graph_ms(wrappers[label]))
            for label in tile_labels:
                case["builds"][label]["ms"].append(
                    cs.time_ms(runs[label], args.iters))
                case["builds"][label]["graph_ms"].append(
                    cs.graph_ms(runs[label]))
            for label, run in extra.items():
                row = case["builds"].setdefault(label, {})
                row["ms"] = [cs.time_ms(run, args.iters)]
                row["graph_ms"] = [cs.graph_ms(run)]
            clocks.append(cs.smi("clocks.sm"))
            for label in wrappers:
                wr = case["builds"][label]
                wr["eager_minus_graph_ms"] = [
                    a - b for a, b in zip(wr["ms"], wr["graph_ms"])]
            nbytes = x.numel() * x.element_size() + w.numel() * 4 + T * E * 4
            mhz = min(_mhz(c) for c in clocks)
            case.update(
                sm_clocks=clocks, bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                no_fma_floor_ms=2 * T * D * E / (sms * 128 * mhz * 1e6) * 1e3)
            result["cases"].append(case)
            print(json.dumps(case))
            del x, xf, want
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        b["equal_ordered"] for c in result["cases"]
        for label, b in c["builds"].items()
        if "equal_ordered" in b and label not in ablations)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_router.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
