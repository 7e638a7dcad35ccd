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
(the local_global pattern of masked serving).  ``--head-dim 256`` takes
gemma3-12b's local layer instead (B 4, 16 / 8 heads, S 1536, D 256): K3
causal under the window of 1,024, K4s and K4m on the sliding-window mask
that masked serving builds for it (64 x 64 tiles).  ``--head-dim 192``
takes nemotron-4-340b's served prefill (B 4, 96 / 8 heads: a GQA group of
12, S 1024, D 192): K3 causal, K4s and K4m on ``chip_smoke.serving_mask``
at S 1024.  Beside the builds, each kernel's bound (4 D flops a visible
score entry at the bf16 peak, or the bytes of q, k, v, the indices and
the output once at 3.35 TB/s, whichever is larger) and one
``scaled_dot_product_attention`` call on the same inputs (``is_causal``
for K3 without a window, else the mask's dense boolean; GQA heads
expanded beforehand), timed in the same call.  ``--ablate NAME...``
makes copies of the in-tree source with one named edit each (see
``ABLATE``; ``serial256``: at D 256 the tile loop's steps one after
another, as a first D 256 build had them) and times them as other
builds.  Every build's registers, spills and shared memory (``-Xptxas
-v``) are printed and kept in the JSON.  The builds run in the order
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

import compare_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, Hq, Hkv, S, K3's window) by head dim: llama4-scout's masked slice,
# nemotron-4-340b's served prefill, gemma3-12b's local layer
SHAPES = {128: (4, 40, 8, 2048, None), 192: (4, 96, 8, 1024, None),
          256: (4, 16, 8, 1536, 1024)}
# --ablate: name -> ((text of the in-tree source, its replacement), ...)
# serial256: at D 256 the tile loop's steps one after another (tile j - 1's
# P V lands, then tile j's scores, then its softmax: one set of p fragments
# live, not two), the overlapped loop kept below D 256
_OVERLAPPED = (
    "      tc_scores<D>(sc, q_tile, ring + next * kStage);\n"
    "      hopper::mma_commit();\n"
    "      tc_pv<D>(st.o, p, ring + stage * kStage + kTile);\n"
    "      hopper::mma_commit();\n"
    "      hopper::mma_wait<1>();  // the scores (groups complete in order)\n"
    "      hopper::fence_operands(sc);\n"
    "      PFrags p_next;\n"
    "      tc_softmax<D>(sc, b.kind, q_lo, b.k0, s, st, p_next, alpha);\n"
    "      hopper::mma_wait<0>();  // tile j - 1's P V\n"
    "      hopper::fence_operands(st.o);\n"
    "      hopper::keep(p.hi);\n"
    "      hopper::keep(p.lo);\n"
    "      p = p_next;\n")
_SERIAL = (
    "      tc_pv<D>(st.o, p, ring + stage * kStage + kTile);\n"
    "      hopper::mma_commit();\n"
    "      hopper::mma_wait<0>();\n"
    "      hopper::fence_operands(st.o);\n"
    "      hopper::keep(p.hi);\n"
    "      hopper::keep(p.lo);\n"
    "#pragma unroll\n"
    "      for (int e = 0; e < 32; ++e) sc[e] = 0.f;\n"
    "      hopper::mma_fence();\n"
    "      tc_scores<D>(sc, q_tile, ring + next * kStage);\n"
    "      hopper::mma_commit();\n"
    "      hopper::mma_wait<0>();\n"
    "      hopper::fence_operands(sc);\n"
    "      tc_softmax<D>(sc, b.kind, q_lo, b.k0, s, st, p, alpha);\n")
ABLATE = {
    "serial256": ((_OVERLAPPED, "      if constexpr (D <= 128) {\n"
                   + _OVERLAPPED + "      } else {\n" + _SERIAL
                   + "      }\n"),),
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


def _bind(lib, text) -> ctypes.CDLL:
    """A build of ``flash_attention.cu`` with its three launchers typed."""
    from repro_torch.kernels.flash_attention import kernel as fk
    for name, argtypes in fk._ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _calls(lib, q, k, v, mask, idx, k3_window):
    """K3 (causal, under ``k3_window``), K4m and K4s of ``lib`` on q, k, v:
    name -> call -> output."""
    import torch
    B, HQ, S, D = q.shape
    HKV = k.shape[1]
    bq, bk = mask.bq, mask.bk
    kinds, rows, cols, skinds = idx
    scale = D ** -0.5
    stream = torch.cuda.current_stream().cuda_stream
    window = -1 if mask.window is None else mask.window
    k3w = -1 if k3_window is None else k3_window

    def checked(err):
        if err:
            raise RuntimeError(f"launch returned {err}")

    def k3():
        out = torch.empty_like(q)
        checked(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, HQ,
            HKV, S, S, D, bq, bk, 1, S, k3w, 0, scale, 1, stream))
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
    ap.add_argument("--head-dim", type=int, default=128,
                    choices=sorted(SHAPES))
    ap.add_argument("--ablate", nargs="*", default=[], choices=list(ABLATE),
                    help="copies of the in-tree source, one edit each")
    args = ap.parse_args()
    D = args.head_dim
    B, HQ, HKV, S, k3_window = SHAPES[D]
    import torch
    if not torch.cuda.is_available():
        print("compare_flash: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    out_dir = os.path.join(ROOT, "build", "compare_flash")
    os.makedirs(out_dir, exist_ok=True)
    header = build.SOURCES["flash_attention"].parent / "hopper.cuh"
    with open(os.path.join(out_dir, header.name), "w") as f:
        f.write(header.read_text())    # beside the ablated copies
    others = args.others + common.ablate("flash_attention", ABLATE,
                                         args.ablate, out_dir)
    resources = {}
    log = build.build_all(["flash_attention"])["flash_attention"]["log"]
    if log:
        resources["in-tree"] = chip_smoke.kernel_resources(log)
    libs = {}
    for src, (lib, res) in common.build_all(others, out_dir,
                                            _bind).items():
        libs[src], resources[src] = lib, res
    libs["in-tree"] = fk._lib()
    for label, rows in resources.items():
        for kern, used, spills in rows:
            if f"<{D}>" in kern or f"ILi{D}E" in kern:
                print(f"{label} {kern}: {used}; {spills}")

    if k3_window is None:
        _, mask = chip_smoke.serving_mask(types.SimpleNamespace(hd=D), S)
    else:
        from repro_torch.core.masks import BlockMask
        mask = BlockMask.sliding_window(S, S, k3_window, bq=64, bk=64)
    g = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, HQ, S, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((B, HKV, S, D), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    st = mask.lower(bucket=True)
    idx = tuple(torch.as_tensor(a).to("cuda", torch.int32) for a in
                (mask.tile_kinds, st.rows, st.cols, st.kinds))
    runs = {name: _calls(lib, q, k, v, mask, idx, k3_window)
            for name, lib in libs.items()}
    plain = {
        "flash_attention": ref.flash_attention_ref(
            q, k, v, causal=True, window=k3_window, bq=mask.bq, bk=mask.bk),
        "flash_attention_masked": ref.flash_attention_masked_ref(
            q, k, v, mask.tile_kinds, skv=S, window=mask.window),
        "flash_attention_sparse": ref.flash_attention_sparse_ref(
            q, k, v, st.rows, st.cols, st.kinds, skv=S, window=mask.window,
            bq=mask.bq, bk=mask.bk)}
    result = {"card": card, "shape": {"B": B, "Hq": HQ, "Hkv": HKV, "S": S,
                                      "D": D, "dtype": "bfloat16",
                                      "k3_window": k3_window},
              "tiles": [mask.bq, mask.bk], "mask": str(mask),
              "order": "others, in-tree, in-tree, others reversed",
              "resources": resources, "kernels": {}}
    order = others + ["in-tree", "in-tree"] + list(reversed(others))
    import torch.nn.functional as F
    from repro_torch.core.masks import BlockMask
    g_ = HQ // HKV
    k_rep, v_rep = k.repeat_interleave(g_, 1), v.repeat_interleave(g_, 1)
    causal = BlockMask.full(S, S, bq=mask.bq, bk=mask.bk, causal=True,
                            window=k3_window)
    k3_sdpa = (dict(is_causal=True) if k3_window is None else
               dict(attn_mask=torch.from_numpy(causal.dense_mask()).cuda()))
    dense = torch.from_numpy(mask.dense_mask()).cuda()
    sdpa = {"flash_attention": lambda: F.scaled_dot_product_attention(
                q, k_rep, v_rep, **k3_sdpa),
            "flash_attention_masked": lambda: F.scaled_dot_product_attention(
                q, k_rep, v_rep, attn_mask=dense),
            "flash_attention_sparse": lambda: F.scaled_dot_product_attention(
                q, k_rep, v_rep, attn_mask=dense)}
    idx_bytes = {"flash_attention": 0,
                 "flash_attention_masked": idx[0].numel() * 4,
                 "flash_attention_sparse": 3 * idx[1].numel() * 4}
    for kname, want in plain.items():
        base = runs["in-tree"][kname]()
        m = causal if kname == "flash_attention" else mask
        entries = int(m.dense_mask().sum())
        ops_ms = 4 * B * HQ * D * entries / chip_smoke.BF16_FLOP_PER_S * 1e3
        bytes_ms = ((2 * q.numel() + k.numel() + v.numel()) * 2
                    + idx_bytes[kname]) / chip_smoke.HBM_BYTES_PER_S * 1e3
        row = {"largest": want.float().abs().max().item(), "builds": {},
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "visible_entries_per_head": entries,
               "sdpa_ms": _time_ms(sdpa[kname], args.iters)}
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
