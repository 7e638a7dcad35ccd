"""MoE dispatch as SpMM, the port's counterpart of the reference's
``benchmarks/bench_moe.py``: expert dispatch formulations on a Scout-like
layer (T 4096 tokens of d 256, 16 experts, capacity factor 1.25, d_ff 512).

* ``su_gather_dispatch`` -- index-stream dispatch (``moe.apply_moe``,
  gather by slot: the SU indirection).
* ``onehot_einsum_dispatch`` -- the no-SU baseline: a dense one-hot
  dispatch tensor through two einsums, O(T*E*C*d) instead of O(T*d).  Plain
  torch, as in the reference (it is not a kernel there either).
* ``backend_gather`` / ``backend_bcsr_engine`` -- the same layer at TB 512,
  DB 128, gather against the dispatch matrix as a routed ``BatchedBCSR``
  through K2 (the host compacts the stream), ``torch.equal``.
* ``backend_bcsr_two_phase`` -- route (host compaction) then execute, with
  the routed stream's size against the full grid; ``torch.equal`` to
  gather.
* ``two_phase_chain_pipelined`` -- 8 two-phase layers back to back, each
  execute waited for, against one left in flight behind the next route
  (``engine.StreamPipeline(1)``); ``torch.equal``.
* ``bcsr_kernel_dispatch`` / ``bcsr_batched_dispatch`` -- a dispatch
  matrix times a dense block through ``spmm.ops.spmm`` / ``spmm_batched``.

``run_host_dispatch`` times the decode-step host tax: the op-by-op route
(``moe.route_tokens`` and the slot ``where``) against ``moe.route_phase1``,
and the layered decode step eagerly against the fused ``model.decode_step``.

Where the reference jit-compiles a call, the port replays a CUDA graph of
the same call on the card (:func:`graphed`) when the call reads nothing on
the host, and runs it eagerly otherwise; each row says which.  The
reference's ``(interp)`` rows are ``(kernel)`` on the card (K2) and
``(plain)`` on the CPU (K2's plain version).  The tiles come from
``tuning.moe_dispatch_tiles`` and are recorded, not registered.  ``smoke``
shrinks T / D / TB / DB so the CPU runs it in seconds.

    python -m repro_torch.benchmarks.bench_moe [--smoke] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.benchmarks.common import emit_bench, row, time_fn
from repro_torch.configs import get_smoke
from repro_torch.core.formats import batched_bcsr_from_dense, bcsr_from_dense
from repro_torch.kernels import engine, tuning
from repro_torch.kernels.spmm import ops as spmm_ops
from repro_torch.models import model as M
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ArchConfig

E, CF, FF = 16, 1.25, 512
# T, D of the dispatch A/B; TB, DB of the in-layer backend A/B
SHAPES = {False: dict(T=4096, D=256, TB=512, DB=128),
          True: dict(T=256, D=64, TB=64, DB=32)}
N_CHAIN = 8


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"bench_moe: {msg}")


def layer_cfg(d_model: int) -> ArchConfig:
    """The benchmark's MoE layer: llama4-scout SMOKE at ``d_model``, d_ff
    FF, E experts, capacity factor CF, no shared expert."""
    return dataclasses.replace(
        get_smoke("llama4-scout-17b-a16e"), d_model=d_model, d_ff=FF,
        n_experts=E, capacity_factor=CF, moe_shared_expert=False)


def init_layer(cfg: ArchConfig, device) -> dict:
    """One MoE layer's params (``moe.init_moe``, seed 0) on ``device``, in
    f32 as the reference's ``init_moe`` makes them: its layer multiplies
    the f32 tokens by f32 weights."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    p = moe_mod.init_moe(g, cfg, n=1, dtype=torch.float32, device=dev)

    def first(t):
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    return first(p)


def graphed(fn: Callable, device: torch.device) -> tuple:
    """``(call, mode)``: on the card ``call()`` replays one CUDA graph of
    ``fn()`` (``kernels.capture_graph``: a host read in ``fn`` raises) and
    returns its output buffer, each replay adding the launches its capture
    recorded (mode "graph"); on the CPU ``call`` is ``fn`` itself (mode
    "eager")."""
    if device.type != "cuda":
        return fn, "eager"
    graph, out, launches = kernels.capture_graph(fn, device)

    def call():
        graph.replay()
        kernels.add_launches(launches)
        return out
    return call, "graph"


def onehot_dispatch(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The no-SU baseline: top-1 routing at the fixed capacity
    ``int(T / E * CF)``, a dense (T, E, C) one-hot dispatch tensor, and the
    dispatch and combine as einsums around the expert FFN."""
    _, T, D = x.shape
    xt = x.reshape(T, D)
    gate = torch.softmax(xt @ p["router"].to(xt.dtype), dim=-1)
    top_g, top_e = torch.topk(gate, 1)
    C = int(T / cfg.n_experts * cfg.capacity_factor)
    experts = torch.arange(cfg.n_experts, device=x.device)
    onehot_te = (top_e[:, :1] == experts).to(xt.dtype)          # (T, E)
    pos = (torch.cumsum(onehot_te, dim=0) - 1) * onehot_te
    keep = (pos < C).all(dim=-1)
    slot = torch.where(keep, pos.sum(-1), float(C)).long()
    slots = torch.arange(C + 1, device=x.device)
    disp = onehot_te[:, :, None] * (slot[:, None] == slots).to(
        xt.dtype)[:, None, :C]                                  # (T, E, C)
    xe = torch.einsum("tec,td->ecd", disp, xt)
    ye = moe_mod._expert_ffn(p["experts"], xe, cfg.mlp_type)
    back = torch.einsum("tec,ecd->td", disp, ye)
    return (back * top_g).reshape(1, T, D)


def layer_ab(params_b, xb: torch.Tensor, cfg_b: ArchConfig,
             device: torch.device) -> dict:
    """The in-layer backend A/B at (1, TB, DB): gather (graphed) against
    bcsr with the stream compacted on the host (eager), then two-phase
    (route eager, execute graphed), then the route -> execute chain serial
    against pipelined.  Raises unless bcsr, two-phase and the pipelined
    chain are ``torch.equal`` to their counterparts.  Returns the times
    (seconds), the route's stream ``info``, the tiles, the modes and the
    gather output ``out``."""
    def tf(fn):
        return time_fn(fn, device=device)

    gth, gth_mode = graphed(lambda: moe_mod.apply_moe(
        params_b, xb, cfg_b, dispatch="gather")[0], device)
    t_gth = tf(gth)
    ref = gth().clone()
    t_bcsr = tf(lambda: moe_mod.apply_moe(params_b, xb, cfg_b,
                                          dispatch="bcsr")[0])
    got = moe_mod.apply_moe(params_b, xb, cfg_b, dispatch="bcsr")[0]
    _check(torch.equal(ref, got), "backends diverge")

    plan, info = moe_mod.route_moe(params_b, xb, cfg_b, dispatch="bcsr")
    t_route = tf(lambda: moe_mod.route_moe(params_b, xb, cfg_b,
                                           dispatch="bcsr")[0].flat_slot)
    ex, ex_mode = graphed(lambda: moe_mod.execute_moe(params_b, xb, plan,
                                                      cfg_b)[0], device)
    t_exec = tf(ex)
    _check(torch.equal(ref, ex()), "two-phase diverges")

    def chain(pipe: engine.StreamPipeline):
        out = xb
        for _ in range(N_CHAIN):
            plan_i, _ = moe_mod.route_moe(params_b, out, cfg_b,
                                          dispatch="bcsr")
            out, _ = moe_mod.execute_moe(params_b, out, plan_i, cfg_b)
            pipe.push("exec", out)      # depth 0 waits it out at once
        pipe.drain()
        return out

    t_ser = tf(lambda: chain(engine.StreamPipeline(0)))
    t_pip = tf(lambda: chain(engine.StreamPipeline(1)))
    _check(torch.equal(chain(engine.StreamPipeline(0)),
                       chain(engine.StreamPipeline(1))),
           "pipelined chain diverges")
    return {"gather": t_gth, "bcsr": t_bcsr, "route": t_route,
            "exec": t_exec, "chain_serial": t_ser, "chain_pipelined": t_pip,
            "info": info, "modes": {"gather": gth_mode, "exec": ex_mode},
            "tiles": tuning.moe_dispatch_tiles(cfg_b.d_model, xb.dtype,
                                               device), "out": ref}


def run(bench_json: Optional[dict] = None, *, smoke: bool = False,
        device="cuda", init: Optional[Callable] = None) -> list:
    """The dispatch A/B rows; fills ``bench_json["two_phase"]``.  ``init``
    (cfg, device) gives a layer's params (default :func:`init_layer`);
    the inputs come from ``default_rng(0)`` in the reference's order."""
    device = resolve_device(device)
    init = init or init_layer
    s = SHAPES[smoke]
    T, D, TB, DB = s["T"], s["D"], s["TB"], s["DB"]
    kernel = "kernel" if device.type == "cuda" else "plain"
    rng = np.random.default_rng(0)
    rows = []
    cfg = layer_cfg(D)
    params = init(cfg, device)
    x = torch.from_numpy(rng.standard_normal((1, T, D)).astype(
        np.float32)).to(device)

    su, su_mode = graphed(lambda: moe_mod.apply_moe(
        params, x, cfg, dispatch="gather")[0], device)
    t_su = time_fn(su, device=device)
    oh, oh_mode = graphed(lambda: onehot_dispatch(params, x, cfg), device)
    t_oh = time_fn(oh, device=device)

    cfg_b = layer_cfg(DB)
    params_b = init(cfg_b, device)
    xb_in = torch.from_numpy(rng.standard_normal((1, TB, DB)).astype(
        np.float32)).to(device)
    ab = layer_ab(params_b, xb_in, cfg_b, device)
    info, tiles = ab["info"], ab["tiles"]
    if bench_json is not None:
        bench_json["two_phase"] = {
            "tokens": TB, "experts": E, "d_model": DB,
            "route_us": ab["route"] * 1e6, "exec_us": ab["exec"] * 1e6,
            "gather_jit_us": ab["gather"] * 1e6,
            "nnzb_stream": info["nnzb_stream"],
            "nnzb_routed": info["nnzb_routed"],
            "grid_nnzb": info["grid_nnzb"],
            "stream_reduction": info["grid_nnzb"] / info["nnzb_stream"],
            "chain_layers": N_CHAIN,
            "serial_chain_us": ab["chain_serial"] * 1e6,
            "pipelined_chain_us": ab["chain_pipelined"] * 1e6,
            "overlap_speedup": ab["chain_serial"] / ab["chain_pipelined"],
            "tiles": tiles, "modes": ab["modes"],
        }

    # a dispatch matrix (T/4 x T, one 1 a row) as 8 x 8 BCSR through K2
    sel = rng.permutation(T)[: T // 4]
    disp_dense = np.zeros((T // 4 * 8 // 8 * 8, T), np.float32)
    for i, c in enumerate(sel[: disp_dense.shape[0]]):
        disp_dense[i, c] = 1.0
    a = bcsr_from_dense(disp_dense[: (T // 4) // 8 * 8], (8, 8),
                        device=device)
    xd = torch.from_numpy(rng.standard_normal((T, 128)).astype(
        np.float32)).to(device)
    t_k = time_fn(lambda: spmm_ops.spmm(a, xd), device=device)
    useful = spmm_ops.flops(a, 128)

    # batched per-expert dispatch: E' (C x T) selections on one union stream
    Eb, Cap, Tb = 4, 64, 512
    disp = np.zeros((Eb, Cap, Tb), np.float32)
    for e in range(Eb):
        picks = rng.permutation(Tb)[:Cap]
        disp[e, np.arange(Cap), picks] = 1.0
    abat = batched_bcsr_from_dense(disp, (8, 8), device=device)
    xb = torch.from_numpy(rng.standard_normal((Tb, 128)).astype(
        np.float32)).to(device)
    t_bat = time_fn(lambda: spmm_ops.spmm_batched(abat, xb), device=device)

    t_gth, t_bcsr = ab["gather"], ab["bcsr"]
    t_route, t_exec = ab["route"], ab["exec"]
    t_ser, t_pip = ab["chain_serial"], ab["chain_pipelined"]
    rows.append(row("moe/su_gather_dispatch", t_su * 1e6,
                    f"tokens={T};experts={E};capacity_factor={CF};"
                    f"mode={su_mode}"))
    rows.append(row("moe/onehot_einsum_dispatch", t_oh * 1e6,
                    f"speedup_su_vs_onehot={t_oh / t_su:.2f}x;"
                    f"mode={oh_mode}"))
    rows.append(row("moe/backend_gather(jit)", t_gth * 1e6,
                    f"tokens={TB};experts={E};d={DB};"
                    f"mode={ab['modes']['gather']}"))
    rows.append(row(f"moe/backend_bcsr_engine({kernel})", t_bcsr * 1e6,
                    f"tokens={TB};experts={E};d={DB};"
                    f"block={tiles['block']};bn={tiles['bn']};"
                    f"gather_vs_bcsr={t_bcsr / t_gth:.2f}x;mode=eager"))
    rows.append(row("moe/backend_bcsr_two_phase(jit)",
                    (t_route + t_exec) * 1e6,
                    f"tokens={TB};experts={E};d={DB};"
                    f"route_us={t_route*1e6:.1f};exec_us={t_exec*1e6:.1f};"
                    f"nnzb_stream={info['nnzb_stream']};"
                    f"nnzb_routed={info['nnzb_routed']};"
                    f"grid_nnzb={info['grid_nnzb']};"
                    f"stream_reduction="
                    f"{info['grid_nnzb'] / info['nnzb_stream']:.1f}x;"
                    f"jit_gather_vs_two_phase="
                    f"{(t_route + t_exec) / t_gth:.2f}x;"
                    f"mode=route eager, execute {ab['modes']['exec']}"))
    rows.append(row("moe/two_phase_chain_pipelined", t_pip * 1e6,
                    f"layers={N_CHAIN};"
                    f"serial_us={t_ser * 1e6:.1f};"
                    f"overlap_speedup={t_ser / t_pip:.2f}x;mode=eager"))
    rows.append(row(f"moe/bcsr_kernel_dispatch({kernel})", t_k * 1e6,
                    f"useful_flops={useful};"
                    f"block_density={a.density():.4f};mode=eager"))
    rows.append(row(f"moe/bcsr_batched_dispatch({kernel})", t_bat * 1e6,
                    f"experts={Eb};useful_flops={spmm_ops.flops(abat, 128)};"
                    f"union_nnzb={abat.nnzb};"
                    f"block_density={abat.density():.4f};mode=eager"))
    return rows


TINY = ArchConfig(
    name="bench-moe-tiny", family="moe", d_model=32, n_heads=2,
    n_kv_heads=1, d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"),
    n_repeats=2, head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")


def run_host_dispatch(bench_json: dict, *, smoke: bool = False,
                      device="cuda") -> list:
    """The decode-step host-dispatch tax, two A/Bs at decode shapes:

    * **route phase**: the op-by-op route (``moe.route_tokens`` and the
      slot ``where``, eagerly) against ``moe.route_phase1`` (graphed on the
      card), 4 tokens at position 7;
    * **decode step** (TINY, 2 x 8 prompt, f32 cache): the layered step
      eagerly (``model.decode_step_layered``) against the fused
      ``model.decode_step`` (graphed on the card) on the same cache.

    The JSON keys keep the reference's names (``eager_pr3``, ``jit``)."""
    device = resolve_device(device)
    DB = SHAPES[smoke]["DB"]
    rng = np.random.default_rng(0)
    rows = []
    cfg_b = layer_cfg(DB)
    params_b = init_layer(cfg_b, device)
    Bd = 4
    x1 = torch.from_numpy(rng.standard_normal((Bd, 1, DB)).astype(
        np.float32)).to(device)
    counts0 = torch.zeros((Bd, E), dtype=torch.int32, device=device)
    pos0 = 7
    C1 = moe_mod.dispatch_capacity(1, cfg_b, pos0=pos0)

    def route_eager():
        r = moe_mod.route_tokens(params_b["router"], x1, cfg_b,
                                 counts=counts0, pos0=pos0)
        return torch.where(r.keep, r.expert_id * C1 + r.within, E * C1)

    route_graph, route_mode = graphed(lambda: moe_mod.route_phase1(
        params_b["router"], x1, cfg_b, counts0, pos0, C1)[3], device)
    _check(torch.equal(route_eager(), route_graph()),
           "route_phase1 != the op-by-op route")
    t_eager = time_fn(route_eager, device=device)
    t_jit = time_fn(route_graph, device=device)
    rows.append(row("moe/route_host_dispatch(eager_pr3)", t_eager * 1e6,
                    f"tokens={Bd}x1;experts={E};mode=eager"))
    rows.append(row("moe/route_host_dispatch(jit)", t_jit * 1e6,
                    f"speedup_vs_pr3={t_eager / t_jit:.2f}x;"
                    f"mode={route_mode}"))

    params_t = M.init_params(TINY, seed=0, device=device)
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, TINY.vocab_size, (2, 8))).to(device)
    logits, cache, pos = M.prefill(params_t, prompts, TINY, max_seq=16,
                                   cache_dtype=torch.float32)
    tok = torch.argmax(logits[:, -1, :TINY.vocab_size],
                       dim=-1)[:, None].to(torch.int32)
    pos_dev = torch.full((2,), int(pos), dtype=torch.int64, device=device)

    def step_layered():
        return M.decode_step_layered(params_t, TINY, cache, int(pos),
                                     tok)[0]

    step_fused, step_mode = graphed(lambda: M.decode_step(
        params_t, TINY, cache, pos_dev, tok)[0], device)
    t_step_jit = time_fn(step_fused, device=device)
    t_step_eager = time_fn(step_layered, device=device)
    n_layers = TINY.n_repeats * len(TINY.block_unit)
    rows.append(row("moe/decode_step_layered(eager_pr3)", t_step_eager * 1e6,
                    f"layers={n_layers};op_by_op;mode=eager"))
    rows.append(row("moe/decode_step_layered(jit_layers)", t_step_jit * 1e6,
                    f"speedup_vs_pr3={t_step_eager / t_step_jit:.2f}x;"
                    f"mode={step_mode}"))
    bench_json["host_dispatch"] = {
        "route_eager_pr3_us": t_eager * 1e6,
        "route_jit_us": t_jit * 1e6,
        "route_speedup": t_eager / t_jit,
        "decode_step_eager_pr3_us": t_step_eager * 1e6,
        "decode_step_jit_layers_us": t_step_jit * 1e6,
        "decode_step_speedup": t_step_eager / t_step_jit,
        "shapes": {"route": [Bd, 1, DB], "tiny_arch": TINY.name,
                   "decode_layers": n_layers},
        "modes": {"route": route_mode, "decode_step": step_mode},
    }
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    bench_json: dict = {"device": str(device), "smoke": args.smoke}
    rows = run(bench_json, smoke=args.smoke, device=device)
    rows += run_host_dispatch(bench_json, smoke=args.smoke, device=device)
    bench_json["rows"] = rows
    path = emit_bench("moe", bench_json, device=device)
    print("\n".join(rows))
    print(f"# wrote {path}")
    return bench_json


if __name__ == "__main__":
    main()
