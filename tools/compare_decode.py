"""Time D1 (``kernels/flash_attention/csrc/decode_attention.cu``) against other builds of it, in one run.

Each extra argument is the path of another ``decode_attention.cu``, for
example the one before this design (the card's copy has no ``.git``, so
make it first):

    git show HEAD~1:src/repro_torch/kernels/flash_attention/csrc/decode_attention.cu > build/decode_prev.cu
    git show HEAD~1:src/repro_torch/kernels/flash_attention/kernel.py > build/decode_prev.py
    python3 tools/compare_decode.py build/decode_prev.cu --wrapper build/decode_prev.py

A source whose ``decode_attention_launch`` takes a ``scores`` scratch
(the earlier interface) is given one, allocated once outside the timings.
``--wrapper PATH`` is another version of ``flash_attention/kernel.py``: its
``decode_attention``, on the library of the first other source, is timed
eagerly and from a graph beside the in-tree wrapper, in the order other,
in-tree, in-tree, other, so that the wrappers' host costs (the earlier
one allocates its scratch each call) compare.  ``--ablate NAME...`` makes
copies of the in-tree source with one part removed under
``build/compare_decode/`` (``nobutterfly``: the 31 shuffles of a chunk's
scores dropped, each level adding a lane's own partials -- what the
butterfly costs; ``noscore``: a score's products dropped; ``nopv``: the PV
products and sums dropped; ``nocopy``: no tile copied, K and V never
read) and times
them the same way; they need not agree.

Run from the repository root on a machine with one GPU.  Every source is
built with the flags of ``kernels/build.py``, all at once, and each
build's registers, spills and shared memory per CTA (``-Xptxas -v``; the
in-tree build's dynamic shared memory from its ``decode_attention_info``)
are printed.  The cases, bf16 q and cache, llama4-scout's 40/8 heads of
128, inputs made on the card from one seed: the 4 x 2048 decode step (B 4,
cache 2,064, ``kv_len`` 2,063), the scheduler's top bucket (B 8, cache 544,
per-row lengths: the first 8 prompts of ``chip_smoke.scheduler_trace``,
numpy seed 24, plus one), the 4 x 256 step (B 4, cache 272, 271), B 1 at
cache 2,064 (the fewest clusters) and B 1 at 16,400 positions (past the
CTAs' shared score budget: pass 2 recomputes).  ``--head-dim 256`` takes
gemma3-12b's 16/8 heads of 256 instead: its 4 x 1536 decode step's ring
(B 4, 1,024 slots, every one visible) and global cache (1,600, ``kv_len``
1,537), the scheduler's top bucket on rings (B 8, per-row lengths from
``chip_smoke.gemma_trace``, at most 1,024), a full cache under the window
of 1,024 (B 4, 2,064 positions, ``kv_len`` 2,063) and B 1 on a ring.
``--head-dim 192`` takes nemotron-4-340b's 96/8 heads of 192 (a GQA group
of 12, which D1 takes in two passes of 8 and 4 heads, each reading the
row's K and V once): its 4 x 1024 decode step (B 4, cache 1,056,
``kv_len`` 1,025), the scheduler's top bucket (B 8, cache 1,088, per-row
lengths from ``chip_smoke.dense_trace``), B 1 at 1,056 and B 1 past the
score budget (16,400).  ``--head-dim 64`` (the default under ``--group
1``) takes zamba2-1.2b's shared attention block, 32/32 heads of 64 (a GQA
group of 1): its 4 x 2048 decode step (B 4, cache 2,080, ``kv_len``
2,049), the scheduler's top bucket (B 8, cache 1,088, per-row lengths from
``chip_smoke.dense_trace``) and B 1 at 2,080.  ``--group G`` sets the
query heads to G times the kv heads (at most 16).  The
builds run in the
order others, in-tree, in-tree, others reversed, each timed by CUDA
events over back-to-back launches and again replayed from a CUDA graph
(device time without the host's launch); beside them the wrappers (eager
minus graph: the host cost), ``scaled_dot_product_attention``
(``enable_gqa``, a boolean mask of the visible positions) and the bytes
bound (visible K and V, q, the output and the lengths once at 3.35 TB/s;
beside it, for a group past 8, the bound of the passes, K and V read once
a pass).
The in-tree build must be ``torch.equal`` to
``ref.decode_attention_ordered`` and every build (ablations aside) within
``chip_smoke.decode_tolerance`` of the plain version: exit 1 otherwise.
Each case prints one JSON line; the whole result is the last line and
``chiprun_out/compare_decode.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import compare_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 27
# (Hq, Hkv) by head dim: zamba2-1.2b's shared block, llama4-scout's,
# nemotron-4-340b's, gemma3-12b's
HEADS = {64: (32, 32), 128: (40, 8), 192: (96, 8), 256: (16, 8)}
HBM_BYTES_PER_S = 3.35e12
# --ablate: name -> ((text of the in-tree source, its replacement), ...)
ABLATE = {
    "nobutterfly": (
        ("x[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));",
         "x[j] = __fadd_rn(keep, send);"),),
    "noscore": (
        ("float part = __fmul_rn(qh[0], kf[a][0]);",
         "float part = kf[a][0];"),
        ("part = __fadd_rn(part, __fmul_rn(qh[e], kf[a][e]));",
         "part = __fadd_rn(part, kf[a][e]);"),),
    "nopv": (
        ("acc[h][e] = __fadd_rn(acc[h][e], __fmul_rn(pn, vf[e]));",
         "acc[h][e] = vf[e];"),),
    "nocopy": (("          cp_async16(to + 16 * i, src + kWarps * u * D +\n",
                "          if (false) cp_async16(to + 16 * i, src + kWarps * u * D +\n"),),
}


def _bind(lib, text):
    """A build of ``decode_attention.cu`` bound: (library, takes a
    scratch), the earlier launcher taking a ``scores`` scratch."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    launcher = text[text.index("int decode_attention_launch("):]
    scratch = "scores" in launcher[:launcher.index(")")]
    lib.decode_attention_launch.argtypes = \
        [P] * (6 if scratch else 5) + [I] * 7 + [F] + [I] * 2 + [P]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, scratch


def _launcher(lib, scratch, q, k, v, kv_len, window=None):
    """A launch of one build on (q, k, v, kv_len) under ``window`` (None:
    no window); a build that takes a scratch gets one made here, once."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    B, Hq, _, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lens = kv_len if isinstance(kv_len, torch.Tensor) else None
    scalar = S if lens is not None else int(kv_len)
    keep = ([torch.empty((B, Hq, S), dtype=torch.float32, device="cuda")]
            if scratch else [])
    code = fk._DTYPE_CODE

    def run():
        out = torch.empty_like(q)
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in keep),
            None if lens is None else lens.data_ptr(), scalar, B, Hq, Hkv, S,
            d, -1 if window is None else window, d ** -0.5, code[q.dtype],
            code[k.dtype],
            torch.cuda.current_stream().cuda_stream)
        build.check(lib, err, "decode_attention launch")
        return out
    return run


def cases(head_dim: int = 128):
    """(name, B, cache, kv_len: an int or per-row lengths, window) of the
    run at ``head_dim``."""
    import chip_smoke as cs
    if head_dim == 64:
        bucket = [len(p) + 1 for p, _ in cs.dense_trace(1000)]
        return [("4 x 2048 decode step", 4, 2080, 2049, None),
                ("scheduler top bucket", 8, 1088, bucket, None),
                ("B 1, cache 2,080", 1, 2080, 2049, None)]
    if head_dim == 192:
        bucket = [len(p) + 1 for p, _ in cs.dense_trace(1000)]
        return [("4 x 1024 decode step", 4, 1056, 1025, None),
                ("scheduler top bucket", 8, 1088, bucket, None),
                ("B 1, cache 1,056", 1, 1056, 1025, None),
                ("B 1, past the score budget", 1, 16400, 16400, None)]
    if head_dim == 256:
        ring = [min(len(p) + 1, 1024) for p, _ in cs.gemma_trace(1000)]
        return [("4 x 1536 decode step, ring", 4, 1024, 1024, None),
                ("4 x 1536 decode step, global", 4, 1600, 1537, None),
                ("scheduler top bucket, rings", 8, 1024, ring, None),
                ("full cache under the window", 4, 2064, 2063, 1024),
                ("B 1, ring", 1, 1024, 1024, None)]
    bucket = [len(p) + 1 for p, _ in cs.scheduler_trace(1000)[:8]]
    return [("4 x 2048 decode step", 4, 2064, 2063, None),
            ("scheduler top bucket", 8, 544, bucket, None),
            ("4 x 256 decode step", 4, 272, 271, None),
            ("B 1, cache 2,064", 1, 2064, 2063, None),
            ("B 1, past the score budget", 1, 16400, 16400, None)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="*",
                    help="other decode_attention.cu sources")
    ap.add_argument("--ablate", nargs="*", default=[], choices=list(ABLATE),
                    help="ablation copies of the in-tree source to make, "
                    "build and time")
    ap.add_argument("--wrapper", default=None,
                    help="another flash_attention/kernel.py, timed on the "
                    "first other source's build beside the in-tree wrapper")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--head-dim", type=int, default=None,
                    choices=sorted(HEADS),
                    help="default: 64 under --group 1, else 128")
    ap.add_argument("--group", type=int, default=None,
                    help="query heads a kv head (default: the head dim's "
                    "arch's)")
    args = ap.parse_args()
    D = args.head_dim or (64 if args.group == 1 else 128)
    HQ, HKV = HEADS[D]
    if args.group is not None:
        HQ = args.group * HKV
    import torch
    if not torch.cuda.is_available():
        print("compare_decode: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import chip_smoke as cs
    import torch.nn.functional as F
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref
    card = cs.smi("name,power.limit")
    print(card)
    result = {"card": card, "clocks_before": cs.smi(cs.CLOCKS), "cases": [],
              "resources": {}}
    out_dir = os.path.join(ROOT, "build", "compare_decode")
    os.makedirs(out_dir, exist_ok=True)
    log = build.build_all(["decode_attention"])["decode_attention"]["log"]
    if log:
        result["resources"]["in-tree"] = cs.kernel_resources(log)
    lib = fk._decode_lib()
    result["launch"] = fk.decode_info(D, torch.bfloat16, torch.bfloat16)
    print(f"in-tree launch (bf16, D {D}): {result['launch']}")
    ablations = common.ablate("decode_attention", ABLATE, args.ablate,
                              out_dir)
    others = {}
    for src, (bound, res) in common.build_all(args.others + ablations,
                                              out_dir, _bind).items():
        others[src], result["resources"][src] = bound, res
    for label, rows in result["resources"].items():
        for kern, used, spills in rows:
            print(f"{label} {kern}: {used}; {spills}")
    if args.wrapper and not args.others:
        raise SystemExit("--wrapper needs another source to launch on")
    other_wrapper = (common.load_wrapper(
        args.wrapper, "_decode_lib", others[args.others[0]][0],
        "decode_attention") if args.wrapper else None)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    bf = torch.bfloat16
    for name, B, S, lens, window in cases(D):
        q = torch.randn((B, HQ, 1, D), generator=g, device="cuda").to(bf)
        k = torch.randn((B, HKV, S, D), generator=g, device="cuda").to(bf)
        v = torch.randn((B, HKV, S, D), generator=g, device="cuda").to(bf)
        kv = (torch.tensor(lens, device="cuda") if isinstance(lens, list)
              else lens)
        ends = torch.as_tensor(lens).reshape(-1).expand(B)
        n = ends.clamp(max=S)
        lo = (ends - window).clamp(min=0) if window else torch.zeros_like(n)
        pos = torch.arange(S)[None]
        vis = ((pos < n[:, None]) & (pos >= lo[:, None])).cuda()  # (B, S)
        runs = {src: _launcher(olib, scratch, q, k, v, kv, window)
                for src, (olib, scratch) in others.items()}
        runs["in-tree"] = _launcher(lib, False, q, k, v, kv, window)
        wrappers = {"wrapper": lambda: fk.decode_attention(
            q, k, v, kv_len=kv, window=window)}
        if other_wrapper:
            wrappers[args.wrapper] = lambda: other_wrapper(
                q, k, v, kv_len=kv, window=window)
        mask = vis[:, None, None, :]
        sdpa = {"sdpa": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)}
        plain = ref.decode_attention_ref(q, k, v, kv_len=kv, window=window)
        ordered = ref.decode_attention_ordered(q, k, v, kv_len=kv,
                                               window=window)
        tol = cs.decode_tolerance(plain.float().abs().max().item(), bf, bf)
        case = {"case": name, "B": B, "S_cap": S, "D": D, "heads": [HQ, HKV],
                "passes": -(-(HQ // HKV) // ref.DECODE_PASS_HEADS),
                "kv_len": lens, "window": window, "builds": {}, "tol": tol}
        for label, run in {**runs, **wrappers}.items():
            got = run()
            torch.cuda.synchronize()
            case["builds"][label] = {
                "equal_ordered": bool(torch.equal(got, ordered)),
                "max_abs_err": (got.float() - plain.float()).abs().max()
                .item(), "ms": [], "graph_ms": []}
        order = list(others)
        clocks = [cs.smi("clocks.sm")]
        for label in order + ["in-tree", "in-tree"] + order[::-1]:
            case["builds"][label]["ms"].append(
                cs.time_ms(runs[label], args.iters))
        for label in order + ["in-tree", "in-tree"] + order[::-1]:
            case["builds"][label]["graph_ms"].append(
                cs.graph_ms(runs[label]))
        worder = [w for w in wrappers if w != "wrapper"]
        for label in worder + ["wrapper", "wrapper"] + worder[::-1]:
            case["builds"][label]["ms"].append(
                cs.time_ms(wrappers[label], args.iters))
        for label in worder + ["wrapper", "wrapper"] + worder[::-1]:
            case["builds"][label]["graph_ms"].append(
                cs.graph_ms(wrappers[label]))
        for label, run in sdpa.items():
            case["builds"][label] = {"ms": [cs.time_ms(run, args.iters)],
                                     "graph_ms": [cs.graph_ms(run)]}
        clocks.append(cs.smi("clocks.sm"))
        for label in wrappers:
            wr = case["builds"][label]
            wr["eager_minus_graph_ms"] = [
                a - b for a, b in zip(wr["ms"], wr["graph_ms"])]
        visible = int(vis.sum())
        kv_bytes = 2 * visible * HKV * D * 2
        nbytes = (kv_bytes + 2 * q.numel() * 2
                  + (8 * B if isinstance(lens, list) else 0))
        case.update(sm_clocks=clocks, visible=visible,
                    bytes_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    passes_bytes_bound_ms=(nbytes + (case["passes"] - 1)
                                           * kv_bytes)
                    / HBM_BYTES_PER_S * 1e3)
        result["cases"].append(case)
        print(json.dumps(case))
        del q, k, v, plain, ordered
    result["clocks_after"] = cs.smi(cs.CLOCKS)
    result["all_equal"] = all(
        c["builds"]["in-tree"]["equal_ordered"]
        and c["builds"]["wrapper"]["equal_ordered"] for c in result["cases"])
    result["all_within_tol"] = all(
        b["max_abs_err"] <= c["tol"] for c in result["cases"]
        for label, b in c["builds"].items()
        if "max_abs_err" in b and label not in ablations)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_decode.json"),
              "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if result["all_equal"] and result["all_within_tol"] else 1


if __name__ == "__main__":
    sys.exit(main())
