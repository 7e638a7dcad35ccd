"""Which op makes a request's row depend on the batch it is decoded in?

``ServeScheduler`` decodes a request inside a batch bucket of 1-8 rows;
the same request served alone through ``ServeLoop`` is decoded at B = 1.
Per-row independence makes the two the same function, but a library
product may pick another kernel, and so another summation order, for
another number of rows.  This script looks for that on the card (or on
the CPU with ``--device cpu``):

* ops: row 0 of each decode-step product of llama4-scout at full width
  (bf16: the q / k / v / o projections, the shared expert, the expert
  ``bmm`` at capacity 1 and 2, the unembedding; the router logits through
  the kernel R1 and through the library's f32 product, its plain version)
  and of ``decode_attention`` over a ``max_seq`` 544 cache (the kernel D1,
  and its plain version), computed with the batch at M rows against M = 1
  -- ``torch.equal`` or the largest difference;
* with ``--arch rwkv6-7b``, row 0 of each decode-step op of rwkv6-7b at
  full width instead, as the decode step runs them: the bf16 projections
  of the time and channel mix, the f32 decay LoRA's two products through
  R1, the one-token WKV step through W1 (``y`` and the new state), the
  rmsnorm in row order (its sum of squares through R1) and the
  unembedding; beside them, off the path, the plain versions those kernels
  replaced on the card (the library's f32 LoRA products, the ``einsum``
  contraction and the bonus sum, the library's mean);
* with ``--arch gemma3-12b``, every row of each decode-step op of
  gemma3-12b at full width: the bf16 projections (q, k, v, o, the MLP's
  three, the unembedding), qk_norm and the block norms in row order (their
  sums of squares through R1), ``decode_attention`` through D1 on a ring
  of 1,024 slots and on a global cache (1,280 positions, per-row lengths),
  and beside them the plain versions (the library's mean, the plain
  decode attention); the layer probe then runs a 1,100-token prompt, past
  the window, so the rings have wrapped;
* with ``--arch qwen3-1.7b``, ``qwen2-1.5b`` or ``nemotron-4-340b`` (the
  dense GQA family), the same ops as gemma3-12b's where the arch has them:
  the projections (with qwen2's bias add; nemotron's squared-ReLU MLP has
  no gate), qk_norm (qwen3), the block norm and D1 on a full cache of
  1,280 positions at per-row lengths (nemotron's head dim 192 and GQA
  group 12, which D1 takes in two passes), and their plain versions;
  nemotron's decode products reduce over 18,432 and 73,728;
* with ``--arch musicgen-large`` or ``internvl2-26b`` (the frontend
  configs), the dense family's ops at their widths (the block norms' sums
  of squares through R1 at d 2,048 and 6,144, D1 at MHA 32/32 of 64 and
  GQA 48/8 of 128, internvl2's unembedding to 92,672), and the layer probe
  after the frontend's embedding positions (64 / 256, bf16 0.02 * N(0,
  1) from a seeded generator) prepended to the prompt;
* with ``--arch zamba2-1.2b``, every row of each decode-step op of
  zamba2-1.2b at full width: the shared attention block's ops as for the
  dense family (its one weight set: the projections, the MLP, the block
  norm in row order, D1 at a GQA group of 1 on 1,280 positions), and the
  Mamba-2 mixer's as the step runs them on layer 0's weights: ``w_in``
  (K 2,048, N 8,384), the causal conv with its carry, M1 (the whole step
  from the conv's output to the gated norm's input: its output and
  state), the gated norm in row order (its sum of squares through R1) and
  ``w_out`` (K 4,096); off the path the plain step (``einsum``) and the
  library's mean;
* with ``--arch llama4-maverick-400b-a17b`` (depth 1 by default: one
  dense and one MoE layer, 37.1 GB), every row of each decode-step op:
  the dense layer's as for the dense family (its projections and MLP,
  the block norm in row order, D1 on 1,280 positions), and the MoE
  layer's router through R1 (and its plain f32 library product) at 128
  experts, the expert ``bmm`` over all 128 matrices at capacity 1 and 2
  (each row's dispatch rows against the row's alone), and the shared
  expert's three products;
* layers: one decode step of a request prefilled alone, at B = 1 and as
  row 0 of buckets of 2, 4 and 8 rows (the other rows vacant, as the
  scheduler leaves them), comparing row 0's hidden state after every
  layer and its logits, with the top-2 gap of the logits at B = 1.

Run from the repository root:

    python3 tools/probe_batch_rows.py [--arch rwkv6-7b | gemma3-12b |
        qwen3-1.7b | qwen2-1.5b | nemotron-4-340b | zamba2-1.2b |
        musicgen-large | internvl2-26b | llama4-maverick-400b-a17b]
        [--depth 2] [--device cuda]

It prints one JSON object as its last line and writes the same to
``chiprun_out/batch_rows.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (1, 2, 4, 8)
# (max_seq, prompt) of the layer probe: gemma3-12b's prompt is past its
# window of 1,024
SHAPES = {"gemma3-12b": (1280, 1100)}
DENSE = ("gemma3-12b", "qwen3-1.7b", "qwen2-1.5b", "nemotron-4-340b",
         "musicgen-large", "internvl2-26b")
MAX_SEQ, PROMPT = 544, 300
MAVERICK = "llama4-maverick-400b-a17b"
# block-unit repeats where the default of 2 does not fit the card
DEPTH = {MAVERICK: 1}


def _diff(got, want) -> float:
    """0.0 when bitwise equal, else the largest |difference| (at least
    the smallest positive float, so equal and different never mix)."""
    import torch
    if torch.equal(got, want):
        return 0.0
    return max((got.float() - want.float()).abs().max().item(), 1e-45)


def probe_ops(cfg, params, device) -> dict:
    """Row 0 of each product at M rows against at 1 row."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    from repro_torch.kernels.router.kernel import router_logits
    from repro_torch.kernels.router.ref import router_logits_ref
    g = torch.Generator(device=device).manual_seed(7)
    d, hd = cfg.d_model, cfg.hd
    layer = {k: v[0] if isinstance(v, torch.Tensor) else v
             for k, v in params["blocks"][0]["attn"].items()}
    ffn = params["blocks"][0]["ffn"]
    mats = {"wq": layer["wq"], "wk": layer["wk"], "wv": layer["wv"],
            "wo": layer["wo"], "shared.w_gate": ffn["shared"]["w_gate"][0],
            "shared.w_down": ffn["shared"]["w_down"][0],
            "unembed": params["unembed"]}
    out = {}
    for name, w in mats.items():
        x = torch.randn((max(ROWS), 1, w.shape[0]), generator=g,
                        device=device).to(w.dtype)
        one = (x[:1] @ w)[0]
        out[name] = {m: _diff((x[:m] @ w)[0], one) for m in ROWS[1:]}
    x = torch.randn((max(ROWS), 1, d), generator=g, device=device).to(
        params["embed"].dtype)
    router = ffn["router"][0]
    for name, fn in (("router R1", router_logits),
                     ("router plain (f32 library product)",
                      router_logits_ref)):
        one = fn(x[:1], router)[0]
        out[name] = {m: _diff(fn(x[:m], router)[0], one) for m in ROWS[1:]}
    experts = ffn["experts"]["w_gate"][0]                      # (E, d, ff)
    xe = torch.randn((experts.shape[0], 2 * max(ROWS), d), generator=g,
                     device=device).to(experts.dtype)
    for cap in (1, 2):               # dispatch rows B * C, C the capacity
        one = torch.bmm(xe[:, :cap], experts)[:, 0]
        out[f"experts bmm, capacity {cap}"] = {
            m: _diff(torch.bmm(xe[:, :m * cap], experts)[:, 0], one)
            for m in ROWS[1:]}
    q = torch.randn((max(ROWS), cfg.n_heads, 1, hd), generator=g,
                    device=device).to(torch.bfloat16)
    kv = [torch.randn((max(ROWS), cfg.n_kv_heads, MAX_SEQ, hd), generator=g,
                      device=device).to(torch.bfloat16) for _ in range(2)]
    lens = torch.full((max(ROWS),), PROMPT, device=device)
    for name, fn in (("decode_attention D1", fops.decode_attention),
                     ("decode_attention plain", decode_attention_ref)):
        one = fn(q[:1], kv[0][:1], kv[1][:1], kv_len=lens[:1])[0]
        out[name] = {m: _diff(fn(q[:m], kv[0][:m], kv[1][:m],
                                 kv_len=lens[:m])[0], one)
                     for m in ROWS[1:]}
    return out


def probe_rwkv_ops(cfg, params, device) -> dict:
    """Every row of each rwkv6 decode-step op at M rows against the row
    alone (the largest difference over the rows), on layer 0's weights and
    random inputs of its decode shapes; the ops off the card's path (the
    plain versions of R1's and W1's work) first, the path's after them."""
    import torch
    from repro_torch.kernels.router.kernel import router_logits
    from repro_torch.kernels.wkv import ops as wkv_ops
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import rwkv6
    g = torch.Generator(device=device).manual_seed(7)
    d, n = cfg.d_model, max(ROWS)
    nh, hd = d // rwkv6.HEAD_DIM, rwkv6.HEAD_DIM
    p = M._take(params["blocks"][0], 0)["mixer"]
    cd = params["embed"].dtype
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=device)
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    ops = {name: (lambda x, w=p[name]: x @ w.to(cd), rand(n, 1, p[name]
                                                            .shape[0]).to(cd))
           for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_cr", "w_ck",
                        "w_cv")}
    ops["unembed"] = (lambda x: x @ unemb.to(cd), rand(n, 1, d).to(cd))
    xw = rand(n, 1, d).to(cd)
    ops["decay lora R1"] = (
        lambda x: router_logits(torch.tanh(router_logits(
            x, p["decay_lora_a"])), p["decay_lora_b"]), xw)
    xn = rand(n, 1, d).to(cd)
    ops["rmsnorm, row order (R1)"] = (
        lambda x: L.rmsnorm(p["ln_x"], x, cfg.norm_eps, row_order=True), xn)
    rt, kt, vt = rand(n, nh, hd), rand(n, nh, hd), rand(n, nh, hd)
    et = torch.exp(-rand(n, nh, hd).abs())
    s0 = rand(n, nh, hd, hd)
    rows = torch.arange(n, device=device)
    step = lambda i: wkv_ops.wkv_step(  # noqa: E731
        rt[i], kt[i], vt[i], et[i], p["bonus_u"], s0[i])
    ops["wkv step W1, y"] = (lambda i: step(i)[0], rows)
    ops["wkv step W1, state"] = (lambda i: step(i)[1], rows)
    off_path = {
        "decay lora plain (f32 library products)": (
            lambda x: torch.tanh(x.float() @ p["decay_lora_a"])
            @ p["decay_lora_b"], xw),
        "wkv einsum plain": (
            lambda i: torch.einsum("bht,bhtd->bhd", rt[i], s0[i]), rows),
        "wkv bonus sum plain": (
            lambda i: (rt[i] * p["bonus_u"] * kt[i]).sum(-1), rows),
        "rmsnorm plain (library mean)": (
            lambda x: L.rmsnorm(p["ln_x"], x, cfg.norm_eps), xn)}
    out = {}
    for name, (fn, x) in {**off_path, **ops}.items():
        alone = [fn(x[i:i + 1])[0] for i in range(n)]
        out[name] = {m: max(_diff(fn(x[:m])[i], alone[i]) for i in range(m))
                     for m in ROWS[1:]}
    return out


def probe_dense_ops(cfg, params, device, blk=None) -> dict:
    """Every row of each decode-step op of a dense arch (gemma3-12b, the
    dense GQA family) at M rows against the row alone (the largest
    difference over the rows), on layer 0's weights (or the attention
    block ``blk``) and random inputs of its decode shapes; the plain
    versions off the card's path first, the path's ops after them.  A ring
    cache only where the arch has local layers; qk_norm only where it has
    it; the bias adds where it has them."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention.ref import decode_attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    g = torch.Generator(device=device).manual_seed(7)
    n, d, hd = max(ROWS), cfg.d_model, cfg.hd
    blk = M._take(params["blocks"][0], 0) if blk is None else blk
    cd = params["embed"].dtype
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=device)
    unemb = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    mats = {**{k: blk["attn"][k] for k in ("wq", "wk", "wv", "wo")},
            **{k: blk["ffn"][k] for k in ("w_gate", "w_up", "w_down")
               if k in blk["ffn"]},
            "unembed": unemb}
    ops = {name: (lambda x, w=w: x @ w.to(cd), rand(n, 1, w.shape[0]).to(cd))
           for name, w in mats.items()}
    if cfg.qkv_bias:
        for name, b in (("wq + bq", "bq"), ("wk + bk", "bk")):
            w = blk["attn"]["w" + b[1]]
            ops[name] = (lambda x, w=w, b=blk["attn"][b]: x @ w.to(cd)
                         + b.to(cd), rand(n, 1, w.shape[0]).to(cd))
    xq = rand(n, cfg.n_heads, 1, hd).to(cd)
    xn = rand(n, 1, d).to(cd)
    off_path = {"rmsnorm plain (library mean)": (lambda x: L.rmsnorm(
        blk["ln1"], x, cfg.norm_eps), xn)}
    if cfg.qk_norm:
        ops["qk_norm, row order (R1)"] = (lambda x: L.rmsnorm(
            blk["attn"]["q_norm"], x, cfg.norm_eps, row_order=True), xq)
        off_path["qk_norm plain (library mean)"] = (lambda x: L.rmsnorm(
            blk["attn"]["q_norm"], x, cfg.norm_eps), xq)
    ops["rmsnorm, row order (R1)"] = (lambda x: L.rmsnorm(
        blk["ln1"], x, cfg.norm_eps, row_order=True), xn)
    q = rand(n, cfg.n_heads, 1, hd).to(cd)
    caches = {"global": [rand(n, cfg.n_kv_heads, 1280, hd).to(cd)
                         for _ in range(2)]}
    lens = {"global": torch.randint(1, 1281, (n,), generator=g,
                                    device=device)}
    if "attn_local" in cfg.block_unit:
        caches["ring"] = [rand(n, cfg.n_kv_heads, cfg.local_window, hd
                               ).to(cd) for _ in range(2)]
        lens["ring"] = torch.full((n,), cfg.local_window, device=device)
    rows = torch.arange(n, device=device)
    for which, (k, v) in caches.items():
        for label, fn, table in ((f"decode_attention D1, {which}",
                                  fops.decode_attention, ops),
                                 (f"decode_attention plain, {which}",
                                  decode_attention_ref, off_path)):
            table[label] = (lambda i, fn=fn, k=k, v=v, ln=lens[which]: fn(
                q[i], k[i], v[i], kv_len=ln[i]), rows)
    return _rows_vs_alone({**off_path, **ops})


def _rows_vs_alone(table) -> dict:
    """{name: {M: the largest difference of a row at M rows from the row
    alone}} of every (fn, x) of ``table``."""
    n = max(ROWS)
    out = {}
    for name, (fn, x) in table.items():
        alone = [fn(x[i:i + 1])[0] for i in range(n)]
        out[name] = {m: max(_diff(fn(x[:m])[i], alone[i]) for i in range(m))
                     for m in ROWS[1:]}
    return out


def probe_maverick_ops(cfg, params, device) -> dict:
    """llama4-maverick: the dense layer's ops (:func:`probe_dense_ops` on
    its first layer), then every row of the MoE layer's decode ops on its
    first layer: the router through R1 and its plain version, the expert
    ``bmm`` over all the experts at capacity 1 and 2 (row r's ``cap``
    dispatch rows at M rows against row r alone), the shared expert's
    products; the plain versions off the card's path first."""
    import torch
    from repro_torch.kernels.router.kernel import router_logits
    from repro_torch.kernels.router.ref import router_logits_ref
    from repro_torch.models import model as M
    dense = cfg.block_unit.index("attn")
    out = {f"dense layer {k}": v for k, v in probe_dense_ops(
        cfg, params, device,
        blk=M._take(params["blocks"][dense], 0)).items()}
    ffn = M._take(params["blocks"][cfg.block_unit.index("attn+moe")], 0)[
        "ffn"]
    g = torch.Generator(device=device).manual_seed(10)
    n, d = max(ROWS), cfg.d_model
    cd = params["embed"].dtype
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=device)
    x = rand(n, 1, d).to(cd)
    table = {"router plain (f32 library product)": (
        lambda x: router_logits_ref(x, ffn["router"]), x),
        "router R1": (lambda x: router_logits(x, ffn["router"]), x)}
    table.update({f"shared.{k}": (lambda x, w=w: x @ w.to(cd),
                                  rand(n, 1, w.shape[0]).to(cd))
                  for k, w in ffn["shared"].items()})
    out.update(_rows_vs_alone(table))
    experts = ffn["experts"]["w_gate"]                         # (E, d, ff)
    xe = rand(experts.shape[0], 2 * n, d).to(experts.dtype)
    for cap in (1, 2):               # dispatch rows B * C, C the capacity
        alone = [torch.bmm(xe[:, r * cap:(r + 1) * cap], experts)
                 for r in range(n)]
        out[f"experts bmm ({experts.shape[0]} matrices), capacity {cap}"] = {
            m: max(_diff(torch.bmm(xe[:, :m * cap], experts)[
                :, r * cap:(r + 1) * cap], alone[r]) for r in range(m))
            for m in ROWS[1:]}
    return out


def probe_zamba_ops(cfg, params, device) -> dict:
    """zamba2-1.2b: the shared attention block's ops
    (:func:`probe_dense_ops` on its one weight set, D1 at a group of 1),
    then every row of each Mamba-2 decode op on the first prologue layer's
    weights, as ``mamba2.apply_mamba`` runs them at T = 1; the plain
    versions off the card's path first."""
    import torch
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import mamba_step_plain
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2
    from repro_torch.models import model as M
    out = {f"shared block {k}": v for k, v in probe_dense_ops(
        cfg, params, device, blk=params["shared_attn"]).items()}
    g = torch.Generator(device=device).manual_seed(9)
    n, d = max(ROWS), cfg.d_model
    d_in = cfg.ssm_expand * d
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh, ch = d_in // hd, d_in + 2 * ns
    p = M._take(params["prologue"]["mixer"], 0)
    cd = params["embed"].dtype
    rand = lambda *shape: torch.randn(  # noqa: E731
        shape, generator=g, device=device)
    rows = torch.arange(n, device=device)
    xbc, prev = rand(n, 1, ch).to(cd), rand(n, cfg.ssm_conv - 1, ch).to(cd)
    # the whole step's rows as they lie: views of a conv output row and of
    # a projection row
    conv, proj = rand(n, ch).to(cd), rand(n, p["w_in"].shape[-1]).to(cd)
    rows_of = (conv[:, :d_in], conv[:, d_in:d_in + ns], conv[:, d_in + ns:],
               proj[:, d_in + 2 * ns:2 * d_in + 2 * ns], proj[:, -nh:])
    state = rand(n, nh, hd, ns)
    step = lambda fn, i: fn(  # noqa: E731
        *(t[i] for t in rows_of), p["a_log"], p["dt_bias"], p["d_skip"],
        state[i])
    flat = lambda ts: torch.cat([t.float().flatten(1) for t in ts],  # noqa
                                1)
    y = rand(n, 1, d_in).to(cd)
    off_path = {
        "mamba step plain (einsum)": (lambda i: flat(step(
            mamba_step_plain, i)), rows),
        "mamba gated norm plain (library mean)": (lambda x: L.rmsnorm(
            p["norm"], x, cfg.norm_eps), y)}
    ops = {
        "mamba w_in (K 2048, N 8384)": (lambda x: x @ p["w_in"].to(cd),
                                        rand(n, 1, d).to(cd)),
        "mamba causal conv (carry)": (lambda i: mamba2._causal_conv(
            xbc[i], p["conv_w"].to(cd), p["conv_b"].to(cd), prev[i])[0],
            rows),
        "mamba step M1 (the gated output, state)": (lambda i: flat(step(
            ssd_ops.ssd_step, i)), rows),
        "mamba gated norm, row order (R1)": (lambda x: L.rmsnorm(
            p["norm"], x, cfg.norm_eps, row_order=True), y),
        "mamba w_out (K 4096)": (lambda x: x @ p["w_out"].to(cd), y)}
    out.update(_rows_vs_alone({**off_path, **ops}))
    return out


def probe_layers(cfg, params, device) -> dict:
    """One decode step of a request alone and as row 0 of a bucket (a
    frontend config's request prefilled after its embedding positions)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import _copy_row
    from repro_torch.models import model as M
    from repro_torch.models import moe
    moe_fn = lambda p, h, c, counts=None, pos=None: moe.apply_moe(  # noqa
        p, h, c, counts=counts, pos=pos, dispatch="bcsr")
    g = torch.Generator(device=device).manual_seed(8)
    max_seq, prompt_len = SHAPES.get(cfg.name, (MAX_SEQ, PROMPT))
    prompt = torch.randint(0, cfg.vocab_size, (1, prompt_len), generator=g,
                           device=device)
    emb = None
    if cfg.frontend != "none":
        max_seq += cfg.frontend_tokens
        emb = (0.02 * torch.randn((1, cfg.frontend_tokens, cfg.d_model),
                                  generator=g, device=device)
               ).to(params["embed"].dtype)
    logits, cache1, pos = M.prefill_layered(params, prompt, cfg,
                                            max_seq=max_seq, moe_fn=moe_fn,
                                            embeddings=emb)
    tok = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
    block = M._block
    out = {}
    for rows in ROWS:
        seen = []

        def record(*a, **kw):
            x, c = block(*a, **kw)
            seen.append(x[0].clone())
            return x, c

        cache = M.init_cache(cfg, rows, max_seq, device=device)
        _copy_row(cache, cache1, 0)
        toks = torch.zeros((rows, 1), dtype=torch.long, device=device)
        toks[0] = tok[0]
        p = np.zeros(rows, np.int64)
        p[0] = pos
        M._block = record
        try:
            lg, _ = M.decode_step_layered(params, cfg, cache, p, toks,
                                          moe_fn=moe_fn)
        finally:
            M._block = block
        out[rows] = (seen, lg[0, -1, :cfg.vocab_size].float())
    one_seen, one_lg = out[1]
    top = one_lg.topk(2).values
    res = {"top2_gap_alone": (top[0] - top[1]).item(), "buckets": {}}
    for rows in ROWS[1:]:
        seen, lg = out[rows]
        layers = [_diff(a, b) for a, b in zip(seen, one_seen)]
        res["buckets"][rows] = {
            "first_layer_differing": next(
                (i for i, e in enumerate(layers) if e), None),
            "layer_max_abs_diff": layers, "logits": _diff(lg, one_lg),
            "argmax_equal": bool(lg.argmax() == one_lg.argmax())}
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama4-scout-17b-a16e",
                    choices=["llama4-scout-17b-a16e", MAVERICK, "rwkv6-7b",
                             "zamba2-1.2b", *DENSE])
    ap.add_argument("--depth", type=int, default=None,
                    help="block-unit repeats (default 2; maverick 1)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import repro_torch  # noqa: F401  (sets the numerics flags)
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    device = resolve_device(args.device)
    depth = args.depth or DEPTH.get(args.arch, 2)
    cfg = dataclasses.replace(get_config(args.arch), n_repeats=depth)
    params = M.init_params(cfg, seed=0, device=device)
    card = (torch.cuda.get_device_name(0) if device.type == "cuda"
            else "cpu")
    ops = (probe_dense_ops if args.arch in DENSE else
           {"rwkv6-7b": probe_rwkv_ops, "zamba2-1.2b": probe_zamba_ops,
            MAVERICK: probe_maverick_ops}.get(args.arch, probe_ops))
    result = {"device": card, "torch": torch.__version__,
              "arch": args.arch, "depth": depth,
              "ops": ops(cfg, params, device),
              "layers": probe_layers(cfg, params, device)}
    result["path_ops_equal"] = all(
        e == 0 for name, row in result["ops"].items()
        if "plain" not in name for e in row.values())
    for name, row in result["ops"].items():
        print(f"{name}: row 0 at M rows vs 1 row: " + ", ".join(
            f"M={m} {'equal' if e == 0 else f'{e:.3g}'}"
            for m, e in row.items()))
    lay = result["layers"]
    print("ops on the decode path: row 0 "
          + ("equal at every M" if result["path_ops_equal"] else
             "DIFFERS at some M"))
    print(f"decode step, top-2 logit gap alone {lay['top2_gap_alone']:.4g}")
    for rows, r in lay["buckets"].items():
        print(f"  bucket {rows}: first layer differing "
              f"{r['first_layer_differing']}, logits "
              f"{'equal' if r['logits'] == 0 else r['logits']}, argmax "
              f"{'equal' if r['argmax_equal'] else 'differs'}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    line = json.dumps(result)
    with open(os.path.join(ROOT, "chiprun_out", "batch_rows.json"),
              "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
