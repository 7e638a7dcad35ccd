"""Time K7 (``kernels/wkv/csrc/wkv.cu``) against other builds of it, in one run.

Each extra argument is the path of another ``wkv.cu`` with the same C
interface (``wkv_launch``), for example the previous commit's:

    git show HEAD~1:src/repro_torch/kernels/wkv/csrc/wkv.cu > build/wkv_prev.cu
    python3 tools/compare_wkv.py build/wkv_prev.cu

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``.  On f32 r, k, v, w at the
RWKV slice's shape (B 4, T 2048, 64 heads of 64, chunk 128), with decays
that do (wmag 1.0) and do not (0.05) saturate the clamp, the builds run in
the order others, in-tree, in-tree, others reversed, each timed by CUDA
events; every build's y and final state are compared with the in-tree
kernel's (``torch.equal`` and the largest difference) and with the plain
chunked version.  It prints one JSON object as its last line and writes the
same to ``chiprun_out/compare_wkv.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, NH, HD, CHUNK = 4, 2048, 64, 64, 128


def _time_ms(fn, iters: int, warmup: int = 3) -> float:
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


def _inputs(g, wmag: float):
    """r, k, v ~ N(0, 1), w = max(-|N(0, 1)| * wmag, -1), u ~ 0.1 N(0, 1),
    all f32 on the card (chip_smoke's K7 inputs)."""
    import torch
    shape = (B, T, NH, HD)
    r, k, v = (torch.randn(shape, generator=g, device="cuda")
               for _ in range(3))
    w = torch.clamp(-torch.randn(shape, generator=g, device="cuda").abs()
                    * wmag, min=-1.0)
    u = 0.1 * torch.randn((NH, HD), generator=g, device="cuda")
    return r, k, v, w, u


def _build(src: str, out: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    lib.wkv_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                               + [ctypes.c_void_p])
    lib.wkv_launch.restype = ctypes.c_int
    return lib


def _runner(lib, a):
    """A call of ``lib``'s kernel on inputs ``a``: (y, final state)."""
    import torch
    r, k, v, w, u = a

    def run():
        y = torch.empty_like(r)
        s = torch.empty((B, NH, HD, HD), device="cuda")
        err = lib.wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), y.data_ptr(), s.data_ptr(), B, T, NH, HD, CHUNK,
            0, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"wkv_launch returned {err}")
        return y, s
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other wkv.cu sources")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_wkv: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    from repro_torch.kernels.wkv import ops, ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out_dir = os.path.join(ROOT, "build", "compare_wkv")
    os.makedirs(out_dir, exist_ok=True)
    others = {src: _build(src, os.path.join(out_dir, f"lib{i}.so"))
              for i, src in enumerate(args.others)}
    g = torch.Generator(device="cuda").manual_seed(7)
    result = {"card": card, "shape": [B, T, NH, HD], "chunk": CHUNK,
              "cases": []}
    for wmag in (0.05, 1.0):
        a = _inputs(g, wmag)
        runs = {"in-tree": lambda: ops.wkv_state(*a, chunk=CHUNK)}
        runs.update({src: _runner(lib, a) for src, lib in others.items()})
        y0, s0 = runs["in-tree"]()
        py, ps = ref.wkv_chunked_plain(*a, CHUNK)
        case = {"wmag": wmag, "largest": py.abs().max().item(), "builds": {}}
        for name, fn in runs.items():
            y, s = fn()
            case["builds"][name] = {
                "vs_plain": max((y - py).abs().max().item(),
                                (s - ps).abs().max().item()),
                "vs_in_tree": max((y - y0).abs().max().item(),
                                  (s - s0).abs().max().item()),
                "equal_in_tree": bool(torch.equal(y, y0)
                                      and torch.equal(s, s0)),
                "ms": []}
        order = (list(others) + ["in-tree", "in-tree"]
                 + list(reversed(list(others))))
        for name in order:
            case["builds"][name]["ms"].append(
                _time_ms(runs[name], args.iters))
        result["cases"].append(case)
        print(json.dumps(case))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_wkv.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
