#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. the card (``nvidia-smi`` name and power limit), torch, the TF32 flags;
2. build every CUDA kernel of the port from the sources in this checkout;
3. kernel vs plain version on the card: random BCSR streams (f32 and bf16,
   blocks (8, 8), (8, 16), (16, 8), empty block-rows, bucket-pad entries,
   N not a multiple of the tile);
4. the serving slice at full llama4-scout width (depth cut to 8 layers,
   random bf16 weights from a seed): ``ServeLoop(dispatch="bcsr")`` serves
   4 prompts of 256 tokens and generates 16 tokens greedily, with the
   kernel's launch count read around that run; the captured 0/1 dispatch
   stream of the first MoE layer must give kernel == plain exactly; the
   same weights with ``dispatch="gather"`` must give the same tokens; a
   small f32 config must agree between the card and the CPU;
5. one JSON line per kernel ({"kernels": [...]}: launches, error, times,
   bound) and one with the serving summary;
6. last line: {"ok": true, "device": {...}}.

It exits nonzero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

BATCH, PROMPT, GEN, DEPTH = 4, 256, 16, 8


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
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


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          "allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
          "the port's numerics flags are not set")
    return card


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    res = build.build_all()
    print(f"build: {time.monotonic() - t0:.2f} s for {sorted(res)}")
    for name, r in res.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def _random_stream(rng, B, gm, gn, block, empty_rows, pad, dtype, device):
    import numpy as np
    import torch
    from repro_torch.core.formats import BatchedBCSR
    bm, bk = block
    mask = rng.random((gm, gn)) < 0.35
    mask[list(empty_rows)] = False
    rows, cols = np.nonzero(mask)
    indptr = np.zeros(gm + 1, np.int32)
    np.cumsum(mask.sum(1), out=indptr[1:])
    blocks = rng.standard_normal((B, len(rows), bm, bk)).astype(np.float32)
    a = BatchedBCSR(
        indptr=torch.from_numpy(indptr).to(device),
        block_rows=torch.from_numpy(rows.astype(np.int32)).to(device),
        block_cols=torch.from_numpy(cols.astype(np.int32)).to(device),
        blocks=torch.from_numpy(blocks).to(device=device, dtype=dtype),
        shape=(B, gm * bm, gn * bk), block=block)
    return a.with_capacity(a.nnzb + pad)


def phase_kernel_vs_plain():
    """Random streams through the kernel and its plain version, on the card.
    Tolerances: f32 output within 1e-5 of the largest |value| (the block
    product's terms are summed in another order); bf16 output within one
    bf16 ulp of the largest |value| (a product that rounds to the other side
    of a bf16 tie moves one ulp)."""
    import numpy as np
    import torch
    from repro_torch.kernels.spmm.kernel import spmm_bcsr
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    rng = np.random.default_rng(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (B, gm, gn, block, empty rows, pad, in dtype, out dtype, N)
        (3, 12, 10, (8, 8), (2, 7), 5, f32, f32, 300),
        (2, 9, 6, (8, 16), (0,), 3, f32, f32, 1000),
        (3, 12, 10, (8, 8), (2, 7), 5, bf16, bf16, 300),
        (2, 9, 6, (8, 16), (8,), 7, bf16, bf16, 1000),
        (2, 10, 8, (8, 8), (4,), 4, bf16, f32, 5120 + 40),
        (2, 6, 12, (16, 8), (1,), 2, bf16, bf16, 520),
    ]
    for B, gm, gn, block, empty, pad, dt, odt, N in cases:
        a = _random_stream(rng, B, gm, gn, block, empty, pad, dt, "cuda")
        dense = torch.from_numpy(rng.standard_normal(
            (B, gn * block[1], N)).astype(np.float32)).to("cuda", dt)
        got = spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense,
                        out_dtype=odt, bn=256)
        want = spmm_bcsr_ref(a.indptr, a.block_cols, a.blocks, dense,
                             out_dtype=odt)
        torch.cuda.synchronize()
        big = want.float().abs().max().item()
        err = (got.float() - want.float()).abs().max().item()
        tol = 1e-5 * big if odt == f32 else 2.0 ** (np.floor(np.log2(big)) - 7)
        rows = got.view(B, gm, block[0], N)
        check(all(rows[:, r].abs().max().item() == 0 for r in empty),
              "an empty block-row is not zero")
        print(f"  K2 {str(dt)[6:]}->{str(odt)[6:]} block {block} B={B} "
              f"nnzb={a.nnzb} N={N}: max_abs_err {err:.3g} (tol {tol:.3g})")
        check(err <= tol, f"kernel disagrees with plain: {err} > {tol}")


def _bcsr_moe():
    """The two-phase MoE stage (route, then execute through K2) as the
    ``moe_fn`` of the model's layered prefill."""
    import functools
    from repro_torch.models import moe
    return functools.partial(moe.apply_moe, dispatch="bcsr")


def phase_small_config_card_vs_cpu():
    """The llama4-scout SMOKE config in f32: prefill logits on the card
    (kernel path) agree with the CPU (plain path) within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_smoke("llama4-scout-17b-a16e"), policy="f32")
    cpu = M.init_params(cfg, seed=0, device="cpu")
    gpu = _tree_to(cpu, "cuda")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    want, _, _ = M.prefill_layered(cpu, prompts, cfg, max_seq=32,
                                   moe_fn=_bcsr_moe())
    got, _, _ = M.prefill_layered(gpu, prompts.cuda(), cfg, max_seq=32,
                                  moe_fn=_bcsr_moe())
    err = (got.cpu() - want).abs().max().item()
    print(f"  smoke f32 prefill logits card vs cpu: max_abs_err {err:.3g}")
    check(bool(torch.isfinite(got).all()) and err <= 1e-4,
          f"card and cpu disagree on the smoke config: {err}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_to(v, device) for v in tree)
    return tree.to(device)


def phase_slice():
    """The serving slice at full llama4-scout width, depth 8."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import engine
    from repro_torch.kernels.spmm import kernel
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import model as M

    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_repeats=DEPTH)
    t0 = time.monotonic()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    gb = torch.cuda.memory_allocated() / 1e9
    print(f"slice: {cfg.name} d={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} d_ff={cfg.d_ff} E={cfg.n_experts} "
          f"vocab={cfg.vocab_size} depth={cfg.n_repeats} policy={cfg.policy};"
          f" params {gb:.1f} GB, init {time.monotonic() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=g,
                            device="cuda")
    max_seq = PROMPT + GEN
    loop = ServeLoop(params, cfg, max_seq=max_seq, dispatch="bcsr")
    loop.run(prompts, 2)                      # warm-up: allocator, cuBLAS

    captured = []
    stream_entry = engine.spmm_batched_stream

    def capture(a, dense, **kw):        # keep the first and the last call
        del captured[1:]
        captured.append((a, dense, kw))
        return stream_entry(a, dense, **kw)

    engine.spmm_batched_stream = capture
    kernel.spmm_bcsr.launches = 0
    try:
        tokens = loop.run(prompts, GEN)       # the main path
    finally:
        engine.spmm_batched_stream = stream_entry
    launches = kernel.spmm_bcsr.launches
    summary = loop.summary()
    n_moe = cfg.block_unit.count("attn+moe") * cfg.n_repeats
    print(f"  bcsr run: {launches} K2 launches, "
          f"{summary['execute']['calls']} execute calls, tokens "
          f"{tokens[0, :8].tolist()} ...")
    check(tokens.shape == (BATCH, GEN) and (tokens >= 0).all()
          and (tokens < cfg.vocab_size).all(), "bad token ids")
    check(launches == n_moe * GEN == summary["execute"]["calls"],
          f"K2 launches {launches} != {n_moe} layers x {GEN} passes")

    # the same prompts' prefill logits are finite and pick the first token
    logits, _, _ = M.prefill_layered(params, prompts, cfg, max_seq=max_seq,
                                     moe_fn=_bcsr_moe())
    check(tuple(logits.shape) == (BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite")
    first = logits[:, -1, :cfg.vocab_size].argmax(-1).cpu().numpy()
    check(np.array_equal(first, tokens[:, 0]), "prefill argmax != token 0")

    before = kernel.spmm_bcsr.launches
    gather = ServeLoop(params, cfg, max_seq=max_seq, dispatch="gather")
    g_tokens = gather.run(prompts, GEN)
    check(kernel.spmm_bcsr.launches == before, "gather launched K2")
    check(np.array_equal(g_tokens, tokens), "bcsr tokens != gather tokens")
    print("  gather run: tokens equal to bcsr")
    return cfg, summary, launches, captured


def _stream_times(captured):
    """K2 on one captured dispatch stream: exactness vs plain, then times
    of the kernel, the plain version and one ``torch.bmm`` of the densified
    0/1 matrix, and the bound.  The bound counts each input byte read once
    and each output byte written once (the kernel re-reads dense K-slices
    per stream entry, mostly from L2), and every stream entry's block
    multiply-adds."""
    import torch
    from repro_torch.kernels.spmm.kernel import spmm_bcsr
    from repro_torch.kernels.spmm.ref import spmm_bcsr_ref
    a, dense, kw = captured
    bn = kw.get("bn")
    odt = kw.get("out_dtype") or dense.dtype
    dense = dense.contiguous()
    args = (a.indptr, a.block_cols, a.blocks, dense)
    got = spmm_bcsr(*args, out_dtype=odt, bn=bn)
    want = spmm_bcsr_ref(*args, out_dtype=odt)
    torch.cuda.synchronize()
    check(torch.equal(got, want), "kernel != plain on the dispatch stream")
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: spmm_bcsr(*args, out_dtype=odt, bn=bn), 50)
    plain_ms = time_ms(lambda: spmm_bcsr_ref(*args, out_dtype=odt), 5, 1)
    a_dense = a.todense()
    library_ms = time_ms(lambda: torch.bmm(a_dense, dense), 50)
    B, nnzb, bm, bk = a.blocks.shape
    N = dense.shape[-1]
    nbytes = (a.blocks.numel() * a.blocks.element_size()
              + dense.numel() * dense.element_size()
              + got.numel() * got.element_size()
              + 4 * (a.indptr.numel() + a.block_cols.numel()))
    ops = 2 * B * nnzb * bm * bk * N
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_FLOP_PER_S * 1e3
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms,
            "shape": {"B": B, "nnzb": nnzb, "block": [bm, bk],
                      "K": dense.shape[1], "N": N, "dtype": str(odt)[6:]}}


def phase_measure(captured, launches, card):
    """The K2 row: measured at the prefill stream (the first dispatch of the
    main run), with the last decode step's stream measured beside it."""
    prefill, decode = (_stream_times(c) for c in captured)
    return {"name": "spmm_bcsr", "route": "cuda",
            "source": "src/repro_torch/kernels/spmm/csrc/spmm_bcsr.cu",
            "replaces": "src/repro/kernels/spmm/kernel.py:74",
            "launches": launches, **prefill, "decode_stream": decode,
            "card": card}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (sets the numerics flags)

    t_start = time.monotonic()
    card = phase_card()
    phase_build()
    print("kernel vs plain on the card:")
    phase_kernel_vs_plain()
    phase_small_config_card_vs_cpu()
    cfg, summary, launches, captured = phase_slice()
    row = phase_measure(captured, launches, card)
    serve = {
        "serve": {"arch": cfg.name, "depth": cfg.n_repeats, "batch": BATCH,
                  "prompt": PROMPT, "gen": GEN, "dispatch": "bcsr",
                  "prefill_ms": summary["prefill"]["seconds"] * 1e3,
                  "decode_tok_per_s": summary["decode"]["tok_per_s"],
                  "decode_ms": summary["decode"]["seconds"] * 1e3,
                  "route_ms": summary["route"]["seconds"] * 1e3,
                  "execute_ms": summary["execute"]["seconds"] * 1e3,
                  "route_calls": summary["route"]["calls"],
                  "nnzb_stream_mean": summary["stream"]["nnzb_stream_mean"],
                  "nnzb_routed_mean": summary["stream"]["nnzb_routed_mean"],
                  "grid_nnzb_last": summary["stream"]["grid_nnzb"],
                  "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "card": card,
                  "wall_s": time.monotonic() - t_start}}
    print(json.dumps({"kernels": [row]}))
    print(json.dumps(serve))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
