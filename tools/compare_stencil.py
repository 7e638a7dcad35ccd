"""Time K6b (``kernels/stencil/csrc/stencil.cu``) against other builds of it, in one run.

Each extra argument is the path of another ``stencil.cu``: an earlier one,
whose 3-D stencils go through the general kernel's ``stencil_launch`` (run
at ``--other-tile``, default the earlier tuning row 8 8 64), for example the
one before the march:

    git show HEAD~1:src/repro_torch/kernels/stencil/csrc/stencil.cu > build/stencil_prev.cu
    python3 tools/compare_stencil.py build/stencil_prev.cu

or a variant of the in-tree source with the march (``stencil3d_march_launch``,
run at the in-tree tile), for example a copy under ``build/`` with one
constant changed.  ``--ablations SRC...`` are variants that are timed but
need not agree; ``--ablate NAME...`` makes such copies of the in-tree source
itself under ``build/compare_stencil/`` (``notaps``: each output takes its
centre value, no tap chain; ``nostage``: nothing staged into the ring;
``nostore``: no stores) and times them the same way.

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``, all at once, and each build's
registers and spills per kernel instance (``-Xptxas -v``) are printed.  The
cases, on grids made on the card from one seed: j3d27pt and j3d7pt on a
512^3 interior in f32 and in bf16, and j2d9pt on 16384^2 f32 (the general
kernel, K6a, which the march must leave as it was).  The builds run in the
order others, in-tree, in-tree, others reversed, each timed by CUDA events
over back-to-back launches; the in-tree march also at ``--tiles``;
``F.conv3d`` / ``F.conv2d`` with the taps as weights beside, and a device
copy of as many values as the interior holds (``copy_ms``: the card's own
rate for the bytes a stencil must move).  Every build's
output (and every tile's) is compared with the plain version
(``torch.equal``; exit 1 if any differs, ablations aside).  Each case
prints one JSON line; the whole result is the last line and
``chiprun_out/compare_stencil.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import compare_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N3, N2, SEED = 512, 16384, 4
CASES = (("j3d27pt", "float32"), ("j3d7pt", "float32"),
         ("j3d27pt", "bfloat16"), ("j3d7pt", "bfloat16"),
         ("j2d9pt", "float32"))
HBM_BYTES_PER_S = 3.35e12
# --ablate: name -> ((text of the in-tree source, its replacement), ...)
ABLATE = {
    "notaps": (("    taps<ROT>(acc, cf, std::make_integer_sequence<int, "
                "P::n>{});\n",
                "    for (int i = 0; i < kRunX; ++i)\n"
                "      acc[i] = q[(ROT + 1) % 3][1][i + 1];\n"),),
    "nostage": (("    if (p < nz + 2) {\n", "    if (false) {\n"),),
    "nostore": (("    if (row_out && nrun > 0)\n",
                 "    if (row_out && nrun > 0 && acc[0] == 1234.5f)\n"),),
}


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


def _conv(spec, grid):
    """One PyTorch call computing the stencil: ``F.conv3d`` / ``F.conv2d``
    with the taps as weights (cuDNN TF32 is off in the port)."""
    import torch
    import torch.nn.functional as Fn
    r = spec.radius
    w = torch.zeros((2 * r + 1,) * spec.ndim, device="cuda",
                    dtype=grid.dtype)
    for off, c in zip(spec.offsets, spec.coeffs_f32()):
        w[tuple(o + r for o in off)] = c
    conv = Fn.conv3d if spec.ndim == 3 else Fn.conv2d
    w, x = w[None, None], grid[None, None]
    return lambda: conv(x, w)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*",
                    help="other stencil.cu sources: earlier ones (the "
                    "general kernel only) or variants with the march")
    ap.add_argument("--ablations", nargs="*", default=[],
                    help="variants that are timed but need not be equal")
    ap.add_argument("--ablate", nargs="*", default=[], choices=list(ABLATE),
                    help="ablation copies of the in-tree source to make, "
                    "build and time")
    ap.add_argument("--other-tile", type=int, nargs=3, default=[8, 8, 64],
                    metavar=("TZ", "TY", "TX"),
                    help="the 3-D tile of builds without the march (their "
                    "tuning row)")
    ap.add_argument("--tiles", nargs="*", default=[],
                    help="other march tiles TZ,TY,TX at which the in-tree "
                    "build is also timed")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="a subset of the cases, as NAME:DTYPE")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_stencil: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.core.stencils import STENCILS
    from repro_torch.kernels import build, tuning
    from repro_torch.kernels.stencil import kernel, ref
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS), "cases": [],
              "resources": {}}
    out_dir = os.path.join(ROOT, "build", "compare_stencil")
    os.makedirs(out_dir, exist_ok=True)
    ablations = args.ablations + common.ablate("stencil", ABLATE,
                                               args.ablate, out_dir)
    log = build.build_all(["stencil"])["stencil"]["log"]
    if log:
        result["resources"]["in-tree"] = cs.kernel_resources(log)
    others = {}
    for src, (lib, res) in common.build_all(
            args.others + ablations, out_dir,
            lambda lib, text: kernel.bind(lib)).items():
        others[src], result["resources"][src] = lib, res
    for label, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{label} {kern}: {used}; {spills}")
    tiles = [tuple(int(v) for v in t.split(",")) for t in args.tiles]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    grids = {}
    for name, dt in CASES:
        if args.cases is not None and f"{name}:{dt}" not in args.cases:
            continue
        spec = STENCILS[name]
        n = (N3 if spec.ndim == 3 else N2) + 2 * spec.radius
        key = (spec.ndim, spec.radius, dt)
        if key not in grids:
            grids[key] = torch.randn((n,) * spec.ndim, generator=g,
                                     device="cuda").to(getattr(torch, dt))
        grid = grids[key]
        interior = tuple(s - 2 * spec.radius for s in grid.shape)
        fn = kernel.stencil_3d if spec.ndim == 3 else kernel.stencil_2d
        runs = {"in-tree": lambda fn=fn, spec=spec, grid=grid: fn(grid, spec)}
        tile = tuning.stencil_tile(interior, grid.dtype, "cuda")
        for src, lib in others.items():
            if spec.ndim == 3 and hasattr(lib, "stencil3d_march_launch"):
                runs[src] = (lambda lib=lib, spec=spec, grid=grid, tile=tile:
                             kernel.march(grid, spec, tile, lib))
            else:
                t = tuple(args.other_tile) if spec.ndim == 3 else (1, *tile)
                runs[src] = (lambda lib=lib, spec=spec, grid=grid, t=t:
                             kernel._launch(grid, spec, t, "other", lib))
        plain = ref.stencil_ref(grid, spec)
        case = {"case": f"{name} {dt}", "interior": list(interior),
                "tile": list(tile), "builds": {}}
        for label, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            case["builds"][label] = {"equal_plain": bool(torch.equal(got,
                                                                     plain)),
                                     "ms": []}
            del got
        order = [k for k in runs if k != "in-tree"]
        n_it = {k: min(args.iters, max(2, int(50 / _time_ms(run, 1, 1))))
                for k, run in runs.items()}
        for label in order + ["in-tree", "in-tree"] + order[::-1]:
            case["builds"][label]["ms"].append(_time_ms(runs[label],
                                                        n_it[label]))
        if spec.ndim == 3:
            case["tiles"] = {}
            for t in tiles:
                run = (lambda t=t, spec=spec, grid=grid:
                       kernel.march(grid, spec, t))
                case["tiles"][",".join(map(str, t))] = {
                    "equal_plain": bool(torch.equal(run(), plain)),
                    "ms": _time_ms(run, args.iters)}
        conv = _conv(spec, grid)
        case["library_ms"] = _time_ms(conv, 5, 1)
        # the card's own rate for these bytes: a device copy of as many
        # values as the interior holds, out of the grid
        src, dst = grid.view(-1)[:plain.numel()], torch.empty_like(plain)
        case["copy_ms"] = _time_ms(lambda: dst.view(-1).copy_(src),
                                   args.iters)
        del src, dst
        nbytes = grid.element_size() * (grid.numel() + plain.numel())
        case["bytes"] = nbytes
        case["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        result["cases"].append(case)
        print(json.dumps(case))
        del plain
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        b["equal_plain"] for c in result["cases"]
        for label, b in list(c["builds"].items()) + list(
            c.get("tiles", {}).items()) if label not in ablations)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_stencil.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
