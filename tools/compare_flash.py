"""Time the flash kernels (K3, K4m, K4s) against other builds of their source.

Each extra argument is the path of another ``flash_attention.cu`` with the
same C interface (``flash_attention_launch``, ``..._masked_launch``,
``..._sparse_launch``), for example an earlier commit's:

    git show 4a24646:src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu \\
        > build/flash_prev.cu
    python3 tools/compare_flash.py build/flash_prev.cu

A header that such a source includes must lie beside it.  Run from the
repository root on a machine with one GPU.  Every source is built with the
flags of ``kernels/build.py``; the in-tree one is the port's own library
(``flash_attention.kernel._lib``).  On random bf16 q, k, v at the slice's
attention shape (B 4, 40 / 8 heads, S 2048, D 128), K3 runs causal at the
``flash`` tuning row's tiles, K4s and K4m on ``chip_smoke.serving_mask``
(the local_global pattern of masked serving).  The builds run in the order
others, in-tree, in-tree, others reversed, each timed by CUDA events; every
build's output is compared with the in-tree kernel's and with the plain
version (``ref.py``).  It prints one JSON object as its last line and
writes the same to ``chiprun_out/compare_flash.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HQ, HKV, S, D = 4, 40, 8, 2048, 128


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


def _build(src: str, out: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    for name, argtypes in fk._ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _calls(lib, q, k, v, mask, idx):
    """K3, K4m and K4s of ``lib`` on q, k, v: name -> call -> output."""
    import torch
    bq, bk = mask.bq, mask.bk
    kinds, rows, cols, skinds = idx
    scale = D ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    window = -1 if mask.window is None else mask.window

    def checked(err):
        if err:
            raise RuntimeError(f"launch returned {err}")

    def k3():
        out = torch.empty_like(q)
        checked(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, HQ,
            HKV, S, S, D, bq, bk, 1, S, -1, 0, scale, 1, stream))
        return out

    def k4m():
        out = torch.empty_like(q)
        checked(lib.flash_attention_masked_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kinds.data_ptr(),
            out.data_ptr(), B, HQ, HKV, S, S, D, bq, bk, S, window, 0, scale,
            1, stream))
        return out

    def k4s():
        out = torch.empty_like(q)
        checked(lib.flash_attention_sparse_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), skinds.data_ptr(), rows.numel(),
            out.data_ptr(), B, HQ, HKV, S, S, D, bq, bk, S, window, 0, scale,
            1, stream))
        return out
    return {"flash_attention": k3, "flash_attention_masked": k4m,
            "flash_attention_sparse": k4s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*", help="other flash_attention.cu "
                    "sources")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out_dir = os.path.join(ROOT, "build", "compare_flash")
    os.makedirs(out_dir, exist_ok=True)
    libs = {src: _build(src, os.path.join(out_dir, f"lib{i}.so"))
            for i, src in enumerate(args.others)}
    libs["in-tree"] = fk._lib()

    _, mask = chip_smoke.serving_mask(types.SimpleNamespace(hd=D))
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, HQ, S, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, HKV, S, D), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    st = mask.lower(bucket=True)
    idx = tuple(torch.as_tensor(a).to("cuda", torch.int32) for a in
                (mask.tile_kinds, st.rows, st.cols, st.kinds))
    runs = {name: _calls(lib, q, k, v, mask, idx)
            for name, lib in libs.items()}
    plain = {
        "flash_attention": ref.flash_attention_ref(
            q, k, v, causal=True, bq=mask.bq, bk=mask.bk),
        "flash_attention_masked": ref.flash_attention_masked_ref(
            q, k, v, mask.tile_kinds, skv=S, window=mask.window),
        "flash_attention_sparse": ref.flash_attention_sparse_ref(
            q, k, v, st.rows, st.cols, st.kinds, skv=S, window=mask.window,
            bq=mask.bq, bk=mask.bk)}
    result = {"card": card, "shape": {"B": B, "Hq": HQ, "Hkv": HKV, "S": S,
                                      "D": D, "dtype": "bfloat16"},
              "tiles": [mask.bq, mask.bk], "mask": str(mask),
              "order": "others, in-tree, in-tree, others reversed",
              "kernels": {}}
    order = (list(args.others) + ["in-tree", "in-tree"]
             + list(reversed(args.others)))
    for kname, want in plain.items():
        base = runs["in-tree"][kname]()
        row = {"largest": want.float().abs().max().item(), "builds": {}}
        for name in libs:
            got = runs[name][kname]()
            torch.cuda.synchronize()
            row["builds"][name] = {
                "vs_plain": (got.float() - want.float()).abs().max().item(),
                "vs_in_tree": (got.float() - base.float()).abs().max()
                .item(),
                "equal_in_tree": bool(torch.equal(got, base)), "ms": []}
        for name in order:
            row["builds"][name]["ms"].append(
                _time_ms(runs[name][kname], args.iters))
        result["kernels"][kname] = row
        print(kname, json.dumps(row))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_flash.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
