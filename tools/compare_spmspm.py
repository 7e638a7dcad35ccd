"""Time K5 (``kernels/spmspm/csrc/spmspm_ell.cu``) against earlier builds of it, in one run.

Each extra argument is the path of another ``spmspm_ell.cu``: a variant
of the in-tree source (the same C interface, for example a copy under
``build/`` with one constant changed), or an earlier one with the all-pairs
kernel's interface (``spmspm_ell_launch``: A and B streams, the output, R,
La, C, Lb, rows, threads, columns and key chunk per block, the two dtype
codes, the stream), for example the one before the row-wise product:

    git show HEAD~1:src/repro_torch/kernels/spmspm/csrc/spmspm_ell.cu > build/spmspm_prev.cu
    python3 tools/compare_spmspm.py build/spmspm_prev.cu

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``, and each build's registers and
spills per kernel instance (``-Xptxas -v``) are printed.  The streams are
made on the card from one seed as ``chip_smoke.py`` makes them: the
library slice's 8192^2 A at 5 % by B at 1 % (wide, and A quantized per row
to fp8 e4m3 with ``a_scales``) and a sparser pair, A at 1 % by B at 1 %.
The all-pairs builds run at their tuning row (``--other-tiles``: 4 rows,
256 threads, 2048 columns, key chunk 4096), the variants at the in-tree
tiles; ``--ablations`` are variants that are timed but need not agree (a
pass removed, to see what it costs).  The builds run in the order
others, in-tree, in-tree, others reversed, each timed by CUDA events; every
build's output is compared with the in-tree kernel's and, on a band of
rows, with the plain version (``torch.equal``; exit 1 if any differs).  The
in-tree kernel's two passes are also timed apart (B's bucketing, with its
key-range read to the host, and the row-wise product), and the product at
other tiles (``--rows``, ``--widths``).  Each case prints one JSON line;
the whole result is the last line and ``chiprun_out/compare_spmspm.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, BAND, SEED = 8192, 64, 4
PAIRS = (("A 5 % x B 1 %", 0.05, 0.01), ("A 1 % x B 1 %", 0.01, 0.01))
HBM_BYTES_PER_S = 3.35e12


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _build(src: str, out: str):
    """``src`` built with the in-tree flags: (library, resource report)."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.spmspm import kernel
    log = subprocess.run(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src], check=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True).stdout
    lib = ctypes.CDLL(out)
    if hasattr(lib, "spmspm_ell_product"):
        return kernel.bind(lib), cs.kernel_resources(log)
    lib.spmspm_ell_launch.argtypes = ([ctypes.c_void_p] * 6
                                      + [ctypes.c_int] * 10
                                      + [ctypes.c_void_p])
    lib.spmspm_ell_launch.restype = ctypes.c_int
    return lib, cs.kernel_resources(log)


def _runner(lib, ak, av, bk, bv, scales, tiles, rows, width):
    """A call of another build: one with the row-wise interface as the
    in-tree wrapper calls it (``rows``, ``width``), an earlier all-pairs
    kernel at ``tiles`` (rows, threads, columns, key chunk per block)."""
    import torch
    from repro_torch.kernels.spmspm import kernel
    R, La = ak.shape
    C, Lb = bk.shape
    if hasattr(lib, "spmspm_ell_product"):
        return lambda: kernel.row_product(
            ak, av, scales, kernel.bucket_columns(bk, bv, width, lib), C,
            rows, lib)

    def run():
        out = torch.empty((R, C), dtype=torch.float32, device="cuda")
        err = lib.spmspm_ell_launch(
            ak.data_ptr(), av.data_ptr(),
            None if scales is None else scales.data_ptr(), bk.data_ptr(),
            bv.data_ptr(), out.data_ptr(), R, La, C, Lb, *tiles,
            kernel._A_CODE[av.dtype], kernel._B_CODE[bv.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"spmspm_ell_launch returned {err}")
        return out
    return run


def _case(name, runs, plain, iters):
    """Outputs against the in-tree build and, on the first BAND rows,
    against plain; then the timed order."""
    import torch
    first = runs["in-tree"]()
    case = {"case": name, "builds": {}}
    for label, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        case["builds"][label] = {
            "equal_in_tree": bool(torch.equal(got, first)),
            "equal_plain_band": bool(torch.equal(got[:BAND], plain)),
            "ms": []}
    others = [k for k in runs if k != "in-tree"]
    # as many calls as fit 50 ms, between 2 and ``iters``
    n = {k: min(iters, max(2, int(50 / _time_ms(fn, 1, 1)))) for k, fn in
         runs.items()}
    for label in others + ["in-tree", "in-tree"] + others[::-1]:
        case["builds"][label]["ms"].append(_time_ms(runs[label], n[label]))
    return case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*",
                    help="other spmspm_ell.cu sources: earlier all-pairs "
                    "ones (spmspm_ell_launch) or row-wise variants")
    ap.add_argument("--ablations", nargs="*", default=[],
                    help="row-wise variants that are timed but need not be "
                    "equal (a pass removed to see what it costs)")
    ap.add_argument("--other-tiles", type=int, nargs=4,
                    default=[4, 256, 2048, 4096],
                    metavar=("ROWS", "THREADS", "COLS", "KT"),
                    help="the earlier builds' tiles (their tuning row)")
    ap.add_argument("--rows", type=int, nargs="*", default=[1, 2, 4, 8],
                    help="A rows (warps) per block at which the in-tree "
                    "product is also timed")
    ap.add_argument("--widths", type=int, nargs="*",
                    default=[1024, 2048, 4096],
                    help="slab widths W at which the in-tree product is "
                    "also timed")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_spmspm: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.core import precision as P
    from repro_torch.core.formats import INVALID_KEY
    from repro_torch.kernels import build, tuning
    from repro_torch.kernels.spmspm import kernel, ops, ref
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS), "cases": [],
              "resources": {}}
    out_dir = os.path.join(ROOT, "build", "compare_spmspm")
    os.makedirs(out_dir, exist_ok=True)
    log = build.build_all(["spmspm_ell"])["spmspm_ell"]["log"]
    if log:
        result["resources"]["in-tree"] = cs.kernel_resources(log)
    others = {}
    for i, src in enumerate(args.others + args.ablations):
        others[src], result["resources"][src] = _build(
            src, os.path.join(out_dir, f"lib{i}.so"))
    for label, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{label} {kern}: {used}; {spills}")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for pair, da, db in PAIRS:
        ak, av = ops.dense_to_ell_rows(cs._sparse(g, (N, N), da))
        bk, bv = ops.dense_to_ell_cols(cs._sparse(g, (N, N), db))
        na = torch.bincount(ak[ak != INVALID_KEY].long(), minlength=N)
        nb = torch.bincount(bk[bk != INVALID_KEY].long(), minlength=N)
        matches = int((na * nb).sum())
        variants = [("wide", av, None)]
        if pair == PAIRS[0][0]:
            variants.append(("fp8 e4m3 a_scales",
                             *P.quantize_rows(av, "fp8_e4m3")))
        rt, ct = tuning.spmspm_tiles(N, N, ak.shape[1], bk.shape[1],
                                     av.dtype, "cuda")
        width = tuning.spmspm_nt(N, ct, bk.shape[1], av.dtype, "cuda") * ct
        for label, a_vals, scales in variants:
            runs = {"in-tree": lambda a_vals=a_vals, scales=scales:
                    kernel.spmspm_ell(ak, a_vals, bk, bv, a_scales=scales)}
            runs.update({src: _runner(lib, ak, a_vals, bk, bv, scales,
                                      args.other_tiles, rt, width)
                         for src, lib in others.items()})
            plain = ref.spmspm_ell_ref(ak[:BAND], a_vals[:BAND], bk, bv,
                                       a_scales=None if scales is None
                                       else scales[:BAND])
            case = _case(f"{pair}, {label}", runs, plain, args.iters)
            buckets = kernel.bucket_columns(bk, bv, width)
            case["bucket_ms"] = _time_ms(
                lambda: kernel.bucket_columns(bk, bv, width), args.iters)
            case["product_ms"] = {}
            for w in sorted(set(args.widths) | {width}):
                bw = buckets if w == width else \
                    kernel.bucket_columns(bk, bv, w)
                for r in sorted(set(args.rows) | {rt}):
                    if kernel.product_smem_bytes(r, w) > tuning.SMEM_BUDGET:
                        continue
                    run = (lambda r=r, bw=bw: kernel.row_product(
                        ak, a_vals, scales, bw, N, r))
                    got = run()
                    case["builds"]["in-tree"].setdefault(
                        "tiles_equal", []).append(
                        bool(torch.equal(got, runs["in-tree"]())))
                    case["product_ms"][f"rt {r} W {w}"] = _time_ms(
                        run, args.iters)
            case.update(
                tiles={"rt": rt, "W": width}, La=ak.shape[1],
                Lb=bk.shape[1], matches=matches,
                buckets=buckets.span * -(-N // width),
                entries=int(buckets.offsets[-1]),
                bound_ms=(8 * (ak.numel() + bk.numel()) + 4 * N * N)
                / HBM_BYTES_PER_S * 1e3)
            result["cases"].append(case)
            print(json.dumps(case))
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        b["equal_in_tree"] and b["equal_plain_band"]
        and all(b.get("tiles_equal", [True]))
        for c in result["cases"] for label, b in c["builds"].items()
        if label not in args.ablations)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_spmspm.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
