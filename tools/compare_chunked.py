"""Time the chunked prefill attention on narrow operands against the f32-widened one.

``models.layers.chunked_attention`` runs both of its products on bf16 q, k,
v with f32 outputs on the card (``torch.bmm(..., out_dtype=float32)``).
Until the port kept them narrow it widened q, each K and V chunk and p to
f32 first; :func:`chunked_attention_f32` below is that version, kept here
unchanged as the yardstick.  On the same random bf16 q, k, v at the
serving slice's 4 x 2048 prefill shape (B 4, 40 / 8 heads of 128, causal,
KV chunks of 1024), the two run in the order widened, narrow, narrow,
widened, each timed by CUDA events over a few calls, with the peak device
memory of one call; both are held against the f32 oracle
(``flash_attention.ref.attention_ref``) on batch row 0.

Run from the repository root on a machine with one GPU:

    python3 tools/compare_chunked.py [--iters 5]

It prints one JSON object as its last line and writes the same to
``chiprun_out/compare_chunked.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, HQ, HKV, S, HD = 4, 40, 8, 2048, 128


def chunked_attention_f32(q, k, v, *, causal: bool = True, window=None,
                          chunk: int = 1024):
    """The port's chunked attention before its operands were kept narrow:
    q, each K / V chunk and p widened to f32, products in f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.masks import NEG_INF
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = k.shape
    g = Hq // Hkv
    scale = hd ** -0.5
    chunk = min(chunk, Skv)
    pad = (-Skv) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    n_chunks = (Skv + pad) // chunk
    qg = (q * scale).to(k.dtype).reshape(B, Hkv, g, Sq, hd).float()
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)[:, None]
    m = torch.full((B, Hkv, g, Sq, 1), NEG_INF, device=dev)
    l = torch.zeros((B, Hkv, g, Sq, 1), device=dev)
    acc = torch.zeros((B, Hkv, g, Sq, hd), device=dev)
    for ci in range(n_chunks):
        kb = k[:, :, None, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, :, None, ci * chunk:(ci + 1) * chunk].float()
        s = torch.matmul(qg, kb.transpose(-1, -2))
        k_pos = ci * chunk + torch.arange(chunk, device=dev)[None, :]
        mask = k_pos < Skv
        if causal:
            mask = mask & (q_pos >= k_pos)
        if window is not None:
            mask = mask & ((q_pos - k_pos) < window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb)
        m = m_new
    out = acc / torch.where(l == 0, 1.0, l)
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def _time_ms(fn, iters: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("compare_chunked: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models.layers import chunked_attention
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((B, HQ, S, HD), (B, HKV, S, HD),
                                      (B, HKV, S, HD)))
    runs = {"f32_widened": lambda: chunked_attention_f32(q, k, v),
            "narrow": lambda: chunked_attention(q, k, v)}
    outs, peak = {}, {}
    for name, fn in runs.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        outs[name] = fn()
        torch.cuda.synchronize()
        peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
    exact = attention_ref(q[:1], k[:1], v[:1], causal=True).float()
    err = {name: (o[:1].float() - exact).abs().max().item()
           for name, o in outs.items()}
    diff = (outs["narrow"].float() - outs["f32_widened"].float()).abs() \
        .max().item()
    del outs
    ms = {name: [] for name in runs}
    for name in ("f32_widened", "narrow", "narrow", "f32_widened"):
        ms[name].append(_time_ms(runs[name], args.iters))
        print(f"  {name}: {ms[name][-1]:.3f} ms")
    flops = 2 * 2 * B * HQ * S * S * HD        # q k^T and p v, every chunk
    result = {"card": card, "torch": torch.__version__,
              "shape": {"B": B, "Hq": HQ, "Hkv": HKV, "S": S, "D": HD,
                        "dtype": "bfloat16", "chunk": 1024},
              "order": "f32_widened, narrow, narrow, f32_widened",
              "ms": ms, "peak_extra_gb": peak,
              "max_abs_err_vs_f32_oracle_row0": err,
              "narrow_vs_widened_max_abs_diff": diff,
              "gemm_flops": flops}
    print(f"  per call: widened {min(ms['f32_widened']):.3f} ms, narrow "
          f"{min(ms['narrow']):.3f} ms; vs the f32 oracle (row 0): "
          + ", ".join(f"{n} {e:.3g}" for n, e in err.items())
          + f"; peak extra GB {peak}")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare_chunked.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
