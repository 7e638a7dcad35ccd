"""RWKV-6 "Finch" mixer: attention-free, data-dependent per-channel decay.

The port of ``repro/models/rwkv6.py``.  Recurrence (per head, state S in
R^{hd x hd}):
  S_t = diag(w_t) S_{t-1} + k_t (x) v_t
  y_t = r_t S_{t-1} + (r_t . (u (*) k_t)) v_t
with w_t = exp(-exp(w0 + lora(x~_t))).  Prefill runs the chunked form
through ``kernels.wkv.ops.wkv_state`` (K7 on the card, its plain version on
the CPU), which also returns the final state for decode.  A decode step
runs the one-step recurrence through ``kernels.wkv.ops.wkv_step`` (W1) and
both f32 decay-LoRA products through ``kernels.router.kernel.router_logits``
(R1): on the card each sums in one order a row, so a request decodes the
same bits in any batch; on the CPU both take their plain versions, the
reference's arithmetic.  Prefill keeps the library's products (an
admission is a B = 1 prefill alone and in a scheduler alike).

Params are stacked on a leading repeat dim like every slot param of
``models.model``.  ``mu``, ``mu_c`` and the ``w_*`` matmul weights are
stored in the policy's compute dtype (the reference casts them at every
use); the decay LoRA, ``decay_base`` and ``bonus_u`` stay f32, as the
reference uses them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.router import kernel as router_kernel
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ArchConfig

LORA_R = 64
HEAD_DIM = 64


def init_rwkv(g: torch.Generator, cfg: ArchConfig, *, n: int, dtype,
              device):
    """Random mixer params with the reference's scales, ``n`` layers
    stacked; matmul weights and lerp factors in ``dtype``."""
    d, ff = cfg.d_model, cfg.d_ff
    nh = d // HEAD_DIM
    s = d ** -0.5
    kw = dict(n=n, dtype=dtype, device=device)
    f32 = dict(n=n, dtype=torch.float32, device=device)
    p = {"mu": torch.full((n, 5, d), 0.5, dtype=dtype, device=device)}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = L.normal(g, (d, d), s, **kw)
    p.update({
        "decay_base": torch.full((n, d), -6.0, device=device),
        "decay_lora_a": L.normal(g, (d, LORA_R), s, **f32),
        "decay_lora_b": L.normal(g, (LORA_R, d), LORA_R ** -0.5 * 0.1,
                                 **f32),
        "bonus_u": L.normal(g, (nh, HEAD_DIM), 0.1, **f32),
        "ln_x": L.init_rmsnorm(d, n=n, device=device),
        "mu_c": torch.full((n, 2, d), 0.5, dtype=dtype, device=device),
        "w_ck": L.normal(g, (d, ff), s, **kw),
        "w_cv": L.normal(g, (ff, d), ff ** -0.5, **kw),
        "w_cr": L.normal(g, (d, d), s, **kw),
    })
    return p


def _token_shift(x: torch.Tensor, prev=None) -> torch.Tensor:
    """(B, T, d) -> the previous-token stream; ``prev``: (B, 1, d), the
    decode carry (zeros at the start of a sequence)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def apply_rwkv_time(p, x: torch.Tensor, cfg: ArchConfig, *, cache=None,
                    chunk: int = 128, collect: bool = False):
    """Time-mix half.  ``cache``: dict(shift_t (B, 1, d), wkv (B, nh, hd,
    hd)); a decode step writes the new state into ``cache["wkv"]`` in place
    (W1 on the card).  ``collect`` returns the prefill-final cache.
    Returns (out, new_cache)."""
    B, T, d = x.shape
    nh = d // HEAD_DIM
    prev_t = cache["shift_t"] if cache is not None else None
    xx = _token_shift(x, prev_t)
    cd = x.dtype
    xr, xk, xv, xg, xw = (x + (xx - x) * p["mu"][i].to(cd)
                          for i in range(5))
    shape = (B, T, nh, HEAD_DIM)
    r = (xr @ p["w_r"].to(cd)).reshape(shape).float()
    k = (xk @ p["w_k"].to(cd)).reshape(shape).float()
    v = (xv @ p["w_v"].to(cd)).reshape(shape).float()
    g = F.silu(xg @ p["w_g"].to(cd))
    # the data-dependent decay, clamped at -1 so a chunk's decay sums stay
    # within f32 range of the mid-rescaled exponents; decode's products
    # through R1 (bf16 xw is widened exactly there, as by ``.float()``)
    if cache is None:
        lora = (torch.tanh(xw.float() @ p["decay_lora_a"])
                @ p["decay_lora_b"])
    else:
        lora = router_kernel.router_logits(torch.tanh(
            router_kernel.router_logits(xw, p["decay_lora_a"])),
            p["decay_lora_b"])
    w_log = torch.clamp(-torch.exp(p["decay_base"] + lora), min=-1.0)
    w_log = w_log.reshape(shape)
    u = p["bonus_u"]

    if cache is None:
        y, s_last = wkv_ops.wkv_state(r, k, v, w_log, u, chunk=chunk)
        new_cache = ({"wkv": s_last, "shift_t": x[:, -1:]} if collect
                     else None)
    else:
        y, s_last = wkv_ops.wkv_step(r[:, 0], k[:, 0], v[:, 0],
                                     torch.exp(w_log[:, 0]), u,
                                     cache["wkv"], out=cache["wkv"])
        y = y[:, None]
        new_cache = {"wkv": s_last, "shift_t": x[:, -1:]}

    y = y.reshape(B, T, d).to(cd)
    y = L.rmsnorm(p["ln_x"], y, cfg.norm_eps,
                  row_order=cache is not None) * g
    return y @ p["w_o"].to(cd), new_cache


def apply_rwkv_channel(p, x: torch.Tensor, cfg: ArchConfig, *, cache=None,
                       collect: bool = False):
    """Channel-mix half (squared-relu FFN over the token-shifted mix).
    ``cache``: dict(shift_c (B, 1, d))."""
    prev_c = cache["shift_c"] if cache is not None else None
    xx = _token_shift(x, prev_c)
    cd = x.dtype
    xk2 = x + (xx - x) * p["mu_c"][0].to(cd)
    xr2 = x + (xx - x) * p["mu_c"][1].to(cd)
    kk = torch.square(F.relu(xk2 @ p["w_ck"].to(cd)))
    out = torch.sigmoid(xr2 @ p["w_cr"].to(cd)) * (kk @ p["w_cv"].to(cd))
    new_cache = ({"shift_c": x[:, -1:]} if (cache is not None or collect)
                 else None)
    return out, new_cache
