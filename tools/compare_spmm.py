"""Time K2 / K2q (``kernels/spmm/csrc/spmm_bcsr.cu``) against other builds of it, in one run.

Each extra argument is the path of another ``spmm_bcsr.cu`` with the same C
interface (``spmm_bcsr_launch``), for example the previous commit's:

    git show HEAD~1:src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu > build/spmm_prev.cu
    python3 tools/compare_spmm.py build/spmm_prev.cu

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``, and each build's registers
and spills per kernel instance (``-Xptxas -v``) are printed.  No model
weights are needed: the MoE dispatch streams of llama4-scout (E 16,
capacity factor 1.25, 8 x 8 blocks, bucket floor 8) are built by
``moe._build_routed_stream`` from the slots the port's own phase 1 gives
seeded expert choices (:func:`expert_choice`, uniform or Zipf, then
:func:`routed_slots`; B 4, prompts 256 and 2048) against random bf16
tokens of width 5120 on the card; the last stream's slots again at 16 x 8
blocks (bf16 and f32 out: the largest register tile); beside them the
library's K2q shape (a banded 8192^2 fp8 e4m3 BCSR, 8 x 8 blocks, by an
(8192, 4096) f32 dense, as ``chip_smoke.py`` makes it), the same with bf16
dense, and the same matrix at 16 x 8 blocks; each K2q case prints every
build's share of the f32 peak (67 TFLOP/s, 2 flops per block element and
output column).  The other builds run K2q at ``--other-quant-bn`` (512, the
earlier kernel's fp8 row).  The builds run in
the order others, in-tree, in-tree, others reversed, each timed by CUDA
events; every build's output is compared with the in-tree kernel's and
with the plain version (``torch.equal``), then timed once more from a CUDA
graph (device time without the per-call launch); ``--ablations`` are
builds timed the same way whose outputs need not agree (a copy with a pass
removed, to see its cost), and ``--cases quant`` runs the K2q cases alone.
The in-tree kernel is
also timed at other ``bn`` (``--bn``), and beside each 8 x 8 dispatch
stream on that stream without its bucket pad entries, with ``torch.bmm``
of the densified 0/1 matrix.  Each case prints one JSON line; the whole
result is the last line and ``chiprun_out/compare_spmm.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, BATCH, PROMPTS = "llama4-scout-17b-a16e", 4, (256, 2048)
ZIPF_S = 1.1
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def expert_choice(rng: np.random.Generator, B: int, S: int, E: int,
                  zipf: bool) -> np.ndarray:
    """Each token's expert (B, S): uniform, or with Zipf(ZIPF_S) weights
    over the experts."""
    if zipf:
        w = 1.0 / np.arange(1, E + 1) ** ZIPF_S
        return rng.choice(E, size=(B, S), p=w / w.sum())
    return rng.integers(0, E, (B, S))


def routed_slots(expert: np.ndarray, cfg) -> np.ndarray:
    """The flat dispatch slots (B, S) in [0, E * C] (E * C = dropped) that
    the port's phase 1 (``moe.route_moe``) gives a fresh sequence whose
    tokens chose ``expert``: one-hot tokens through a scaled identity
    router, so the port's own routing and capacity rule make the slots."""
    import torch
    from repro_torch.models import moe
    E = cfg.n_experts
    x = torch.from_numpy(np.eye(E, dtype=np.float32)[expert])
    plan, _ = moe.route_moe({"router": 10.0 * torch.eye(E)}, x, cfg,
                            dispatch="gather")
    return plan.flat_slot.numpy()


def dispatch_stream(fs: np.ndarray, cfg, dtype, device, bucket: bool = True,
                    block=None):
    """The routed dispatch stream of slots ``fs`` (B, S) at ``cfg``'s
    dispatch geometry on ``device``, as ``moe.plan_from_phase1`` builds it
    (without its bucket pad entries when ``bucket`` is false; at ``block``
    in place of the tuning row's when given).  Returns (stream, capacity
    C)."""
    from repro_torch.kernels import tuning
    from repro_torch.models import moe
    S = fs.shape[1]
    C = moe.dispatch_capacity(S, cfg)
    tiles = tuning.moe_dispatch_tiles(cfg.d_model, dtype, device)
    bm, bk = block or tiles["block"]
    stream, _, _ = moe._build_routed_stream(
        fs, S, cfg.n_experts, C, bm, bk, dtype, device,
        min_bucket=tiles["min_bucket"] if bucket else None)
    return stream, C


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


def _build(srcs: dict) -> dict:
    """Each ``{label: (src, out)}`` built with the in-tree flags, one
    ``nvcc`` each, all started together: ``{label: (library, resource
    report)}``."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.spmm import kernel
    procs = {label: subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, (src, out) in srcs.items()}
    built = {}
    for label, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {srcs[label][0]} failed:\n{log}")
        lib = ctypes.CDLL(srcs[label][1])
        lib.spmm_bcsr_launch.argtypes = kernel._ARGTYPES
        lib.spmm_bcsr_launch.restype = ctypes.c_int
        built[label] = (lib, cs.kernel_resources(log))
    return built


def _runner(lib, args, bn, out_dtype, scales=None):
    """A call of ``lib``'s kernel with the in-tree wrapper's arguments."""
    import torch
    from repro_torch.kernels.spmm import kernel
    indptr, cols, blocks, dense = args
    B, nnzb, bm, bk = blocks.shape
    code = {**kernel._DTYPE_CODE, **kernel._QUANT_CODE}

    def run():
        out = torch.empty((B, (indptr.numel() - 1) * bm, dense.shape[2]),
                          dtype=out_dtype, device="cuda")
        err = lib.spmm_bcsr_launch(
            indptr.data_ptr(), cols.data_ptr(), blocks.data_ptr(),
            None if scales is None else scales.data_ptr(), dense.data_ptr(),
            out.data_ptr(), B, indptr.numel() - 1, nnzb, bm, bk,
            dense.shape[1], dense.shape[2], bn, code[blocks.dtype],
            code[dense.dtype], code[out_dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"spmm_bcsr_launch returned {err}")
        return out
    return run


def _other_bns(bns, default, dense_dtype, quant_block=None):
    """The ``bns`` other than ``default`` that the kernel takes for
    ``dense_dtype`` (K2q's rule at ``quant_block`` (bm, bk) when given)."""
    from repro_torch.kernels import tuning
    unit = tuning.spmm_col_unit(dense_dtype)

    def takes(bn):
        if quant_block is None:
            return bn % unit == 0 and bn <= 8 * unit
        try:
            tuning.spmm_quant_group(*quant_block, bn, dense_dtype)
        except ValueError:
            return False
        return True
    return [bn for bn in bns if bn != default and takes(bn)]


def _case(name, runs, plain, iters, extra_ms):
    """Outputs against the in-tree build and plain, then the timed order,
    then each build and each of ``extra_ms`` from a CUDA graph
    (``chip_smoke.graph_ms``: device time without the per-call launch)."""
    import torch
    import chip_smoke as cs
    want = plain()
    first = runs["in-tree"]()
    case = {"case": name, "builds": {}}
    for label, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        case["builds"][label] = {
            "equal_in_tree": bool(torch.equal(got, first)),
            "equal_plain": bool(torch.equal(got, want)),
            "max_diff_plain": (got.float() - want.float()).abs().max().item(),
            "ms": []}
    others = [k for k in runs if k != "in-tree"]
    for label in others + ["in-tree", "in-tree"] + others[::-1]:
        case["builds"][label]["ms"].append(_time_ms(runs[label], iters))
    for label in others + ["in-tree"]:
        case["builds"][label]["graph_ms"] = cs.graph_ms(runs[label])
    case.update({k: _time_ms(fn, iters) for k, fn in extra_ms.items()})
    case.update({k.replace("_ms", "_graph_ms"): cs.graph_ms(fn)
                 for k, fn in extra_ms.items()})
    return case


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*",
                    help="other spmm_bcsr.cu sources, each as PATH or "
                    "PATH@BN (bn given to that build, K2 and K2q; default "
                    "--other-bn and --other-quant-bn)")
    ap.add_argument("--ablations", nargs="*", default=[],
                    help="further sources, as PATH or PATH@BN, timed but "
                    "not held equal")
    ap.add_argument("--cases", choices=("all", "quant"), default="all",
                    help="all cases, or the K2q cases alone")
    ap.add_argument("--other-bn", type=int, default=256,
                    help="bn given to the other builds (the parent's 256)")
    ap.add_argument("--other-quant-bn", type=int, default=512,
                    help="bn given to the other builds' K2q (the earlier "
                    "kernel's 512)")
    ap.add_argument("--bn", type=int, nargs="*",
                    default=[128, 256, 512, 1024, 2048],
                    help="further bn at which the in-tree kernel is timed "
                    "(those the dense type and block allow)")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_spmm: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import formats as F
    from repro_torch.kernels import build, tuning
    from repro_torch.kernels.spmm import kernel, ops, ref
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS), "cases": [],
              "resources": {}}
    out_dir = os.path.join(ROOT, "build", "compare_spmm")
    os.makedirs(out_dir, exist_ok=True)
    log = build.build_all(["spmm_bcsr"])["spmm_bcsr"]["log"]
    if log:
        result["resources"]["in-tree"] = cs.kernel_resources(log)
    others, other_bn, other_qbn = {}, {}, {}
    srcs = {}
    for i, arg in enumerate(args.others + args.ablations):
        src, _, bn = arg.partition("@")
        srcs[arg] = (src, os.path.join(out_dir, f"lib{i}.so"))
        other_bn[arg] = int(bn) if bn else args.other_bn
        other_qbn[arg] = int(bn) if bn else args.other_quant_bn
    for arg, (lib, res) in _build(srcs).items():
        others[arg], result["resources"][arg] = lib, res
    for label, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{label} {kern}: {used}; {spills}")
    cfg = get_config(ARCH)
    d, bf16 = cfg.d_model, torch.bfloat16
    rng = np.random.default_rng(11)
    g = torch.Generator(device="cuda").manual_seed(11)
    bn0 = tuning.moe_dispatch_tiles(d, bf16, "cuda")["bn"]

    def dispatch_case(name, fs, block=None, out_dtype=bf16, extras=True):
        a, _ = dispatch_stream(fs, cfg, bf16, "cuda", block=block)
        dense = torch.randn((BATCH, a.shape[2], d), generator=g,
                            device="cuda").to(bf16)
        xargs = (a.indptr, a.block_cols, a.blocks, dense)
        runs = {"in-tree": lambda: kernel.spmm_bcsr(
            *xargs, out_dtype=out_dtype, bn=bn0)}
        runs.update({f"in-tree bn={bn}": (
            lambda bn=bn: kernel.spmm_bcsr(*xargs, out_dtype=out_dtype,
                                           bn=bn))
            for bn in _other_bns(args.bn, bn0, bf16)})
        runs.update({src: _runner(lib, xargs, other_bn[src], out_dtype)
                     for src, lib in others.items()})
        extra_ms = {}
        if extras:
            a_dense = a.todense()
            u, _ = dispatch_stream(fs, cfg, bf16, "cuda", bucket=False,
                                   block=block)
            uargs = (u.indptr, u.block_cols, u.blocks, dense)
            unpadded = lambda: kernel.spmm_bcsr(  # noqa: E731
                *uargs, out_dtype=out_dtype, bn=bn0)
            extra_ms = {"bmm_ms": lambda: torch.bmm(a_dense, dense),
                        "in_tree_unpadded_ms": unpadded}
        case = _case(name, runs,
                     lambda: ref.spmm_bcsr_ref(*xargs, out_dtype=out_dtype),
                     args.iters, extra_ms)
        if extras:
            case["unpadded_equal"] = bool(torch.equal(unpadded(),
                                                      runs["in-tree"]()))
        nbytes = (a.blocks.numel() * 2 + dense.numel() * 2
                  + BATCH * a.shape[1] * d * out_dtype.itemsize
                  + 4 * (a.indptr.numel() + a.nnzb))
        case.update(bn=bn0, block=list(a.block), out=str(out_dtype),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    stats=ops.stream_row_stats(a))
        result["cases"].append(case)
        print(json.dumps(case))

    for S in PROMPTS if args.cases == "all" else ():
        for dist in ("uniform", "zipf"):
            fs = routed_slots(
                expert_choice(rng, BATCH, S, cfg.n_experts, dist == "zipf"),
                cfg)
            dispatch_case(f"dispatch {BATCH}x{S} {dist}", fs)
    # bm 16 (the largest register tile; not on the serving path): the last
    # stream's slots at 16 x 8 blocks, bf16 and f32 out
    for odt in (bf16, torch.float32) if args.cases == "all" else ():
        dispatch_case(f"dispatch {BATCH}x{PROMPTS[-1]} zipf, 16 x 8 blocks, "
                      f"{str(odt).split('.')[-1]} out", fs, block=(16, 8),
                      out_dtype=odt, extras=False)

    def quant_case(name, aq, x):
        qargs = (aq.indptr, aq.block_cols, aq.blocks[None], x[None])
        sc = aq.scales[None]
        bm, bk = aq.block
        bn_q = tuning.spmm_bn(aq.blocks.dtype, "cuda")
        runs = {"in-tree": lambda: kernel.spmm_bcsr(*qargs, scales=sc)}
        runs.update({f"in-tree bn={bn}": (
            lambda bn=bn: kernel.spmm_bcsr(*qargs, scales=sc, bn=bn))
            for bn in _other_bns(args.bn, bn_q, x.dtype, (bm, bk))})
        runs.update({src: _runner(lib, qargs, other_qbn[src],
                                  torch.float32, scales=sc)
                     for src, lib in others.items()})
        case = _case(name, runs, lambda: ref.spmm_bcsr_ref(
            *qargs, out_dtype=torch.float32, scales=sc),
            max(3, args.iters // 10), {})
        flops = 2 * aq.nnzb * bm * bk * x.shape[1]
        for label, b in case["builds"].items():
            b["f32_peak_share"] = flops / (min(b["ms"]) * 1e-3) \
                / F32_FLOP_PER_S
        case.update(bn=bn_q, group=tuning.spmm_quant_group(
                        bm, bk, bn_q, x.dtype),
                    other_bn=args.other_quant_bn, block=[bm, bk],
                    dense=str(x.dtype), nnzb=aq.nnzb, N=cs.SPMM_COLS,
                    flops=flops, bound_ms=flops / F32_FLOP_PER_S * 1e3)
        result["cases"].append(case)
        print(json.dumps(case))
        print("  " + ", ".join(
            f"{label}: {min(b['ms']):.3f} ms, "
            f"{100 * b['f32_peak_share']:.1f} % of the f32 peak"
            for label, b in case["builds"].items()))

    i = torch.arange(cs.SPMM_N, device="cuda")
    band = (i[:, None] - i[None, :]).abs() <= cs.SPMM_BAND
    am = torch.randn((cs.SPMM_N, cs.SPMM_N), generator=g, device="cuda") * band
    del band
    x = torch.randn((cs.SPMM_N, cs.SPMM_COLS), generator=g, device="cuda")
    aq = F.bcsr_from_dense(am, cs.SPMM_BLOCK).quantize("fp8_e4m3")
    quant_case("K2q banded fp8 e4m3", aq, x)
    quant_case("K2q banded fp8 e4m3, bf16 dense", aq, x.to(bf16))
    del aq
    aq = F.bcsr_from_dense(am, (16, 8)).quantize("fp8_e4m3")
    del am
    quant_case("K2q banded fp8 e4m3, 16 x 8 blocks", aq, x)
    del aq, x
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        b["equal_in_tree"] and b["equal_plain"]
        for c in result["cases"] for label, b in c["builds"].items()
        if label not in args.ablations)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_spmm.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
