"""Public attention API of the port: padding, tile choice, kernel dispatch,
and the one-token ``decode_attention``.

``attention`` takes the reference's arguments (minus ``interpret``):

* no mask: K3 (``kernel.flash_attention``), causal / sliding window;
* ``mask=BlockMask``: the stream walk K4s (``mask_impl="sparse"``), the
  masked full grid K4m (``"dense"``, the parity baseline) or the oracle
  (``"ref"``).

Tiles default to the ``flash`` row of ``kernels.tuning``; Sq and Skv are
padded with zeros to tile multiples and the kernels mask keys past the true
KV length, so every shape runs on a kernel.  The O(S^2) oracle runs only
when asked for (``use_kernel=False``, ``mask_impl="ref"``), every use is
counted (:func:`fallback_count`), and ``fallback="error"`` refuses it.

``decode_attention`` is the hand-written kernel D1 on the card (the
reference computes it as array code, no Pallas kernel), its plain version
on the CPU; ``decode_attention_max`` / ``decode_attention_partial`` are
D1's split mode over a shard of a cache whose sequence is split over
ranks, and ``decode_merge`` finishes it from the ranks' partials.
"""
from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.masks import BlockMask
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.kernels.flash_attention.ref import attention_ref

# Oracle fallbacks by reason: no O(S^2) path runs uncounted.
_FALLBACKS: collections.Counter = collections.Counter()
# The index arrays of recent masks on their device, by (signature, impl,
# device): the layers of a prefill share one mask, which is lowered and
# uploaded once.
_INDICES: collections.OrderedDict = collections.OrderedDict()
_INDICES_KEPT = 16


def fallback_count() -> int:
    """Total oracle fallbacks since the last reset."""
    return sum(_FALLBACKS.values())


def fallback_reasons() -> dict:
    return dict(_FALLBACKS)


def reset_fallbacks() -> None:
    _FALLBACKS.clear()


def _note_fallback(reason: str, fallback: str) -> None:
    if fallback == "error":
        raise RuntimeError(
            f"attention would fall back to the O(S^2) reference ({reason}) "
            f"but fallback='error' forbids it")
    if fallback != "ref":
        raise ValueError(f"fallback must be 'ref' or 'error', got {fallback!r}")
    _FALLBACKS[reason] += 1


def pad_seq(t: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad the sequence dim (2) of (B, H, S, D) by ``n`` rows, and lay
    the result out contiguously, as the kernels take it (the model's q, k, v
    are head-transposed views)."""
    return (F.pad(t, (0, 0, 0, n)) if n else t).contiguous()


def tiles(q, k, bq: Optional[int] = None,
          bk: Optional[int] = None) -> tuple:
    """K3's (bq, bk) for q (B, Hq, Sq, D) and k (B, Hkv, Skv, D): the
    ``flash`` row of ``kernels.tuning`` where a tile is not given, then the
    reference's re-clamp, a tile no longer than a sequence it divides."""
    Sq, Skv, D = q.shape[2], k.shape[2], q.shape[3]
    if bq is None or bk is None:
        tbq, tbk = tuning.flash_tiles(Sq, Skv, D, q.dtype, q.device)
        bq, bk = bq or tbq, bk or tbk
    return (min(bq, Sq) if Sq % min(bq, Sq) == 0 else bq,
            min(bk, Skv) if Skv % min(bk, Skv) == 0 else bk)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              bq: Optional[int] = None, bk: Optional[int] = None,
              use_kernel: bool = True, mask: Optional[BlockMask] = None,
              mask_impl: str = "sparse", fallback: str = "ref"
              ) -> torch.Tensor:
    """Streaming attention with GQA and causal / sliding-window / BlockMask
    masks.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D).  Returns (B, Hq, Sq,
    D) in q.dtype.

    ``mask``: a ``core.masks.BlockMask`` takes the masked paths
    (``causal``/``window`` are then ignored in favor of the mask's own
    refinements).  ``use_kernel=False`` takes the counted oracle."""
    if mask is not None:
        return _attention_masked(q, k, v, mask, impl=mask_impl,
                                 fallback=fallback)
    Sq, Skv = q.shape[2], k.shape[2]
    if not use_kernel:
        _note_fallback("use_kernel=False", fallback)
        return attention_ref(q, k, v, causal=causal, window=window)
    bq_eff, bk_eff = tiles(q, k, bq, bk)
    kp = (-Skv) % bk_eff
    out = kernel.flash_attention(
        pad_seq(q, (-Sq) % bq_eff), pad_seq(k, kp), pad_seq(v, kp),
        causal=causal, window=window, bq=bq_eff, bk=bk_eff, skv=Skv)
    return out[:, :, :Sq]


def _mask_indices(mask: BlockMask, impl: str, device) -> tuple:
    """The mask's kind map (``impl="dense"``) or its bucketed (rows, cols,
    kinds) stream (``"sparse"``) as int32 tensors on ``device``, lowered
    and uploaded once per distinct mask."""
    key = (mask.signature(), impl, device)
    hit = _INDICES.get(key)
    if hit is None:
        if impl == "dense":
            arrays = (mask.tile_kinds,)
        else:
            s = mask.lower(bucket=True)
            arrays = (s.rows, s.cols, s.kinds)
        hit = tuple(torch.as_tensor(a).to(device, torch.int32)
                    for a in arrays)
        _INDICES[key] = hit
        if len(_INDICES) > _INDICES_KEPT:
            _INDICES.popitem(last=False)
    return hit


def _attention_masked(q, k, v, mask: BlockMask, *, impl: str,
                      fallback: str = "ref") -> torch.Tensor:
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    if (mask.sq, mask.skv) != (Sq, Skv):
        raise ValueError(f"mask is {mask.sq}x{mask.skv}, attention "
                         f"{Sq}x{Skv}")
    if impl == "ref":
        _note_fallback("mask_impl=ref", fallback)
        return attention_ref(q, k, v, mask=mask)
    if impl not in ("sparse", "dense"):
        raise ValueError(f"mask_impl must be sparse|dense|ref, got {impl!r}")
    qp = mask.n_q_tiles * mask.bq - Sq
    kp = mask.n_kv_tiles * mask.bk - Skv
    qq, kk, vv = pad_seq(q, qp), pad_seq(k, kp), pad_seq(v, kp)
    indices = _mask_indices(mask, impl, q.device)
    if impl == "dense":
        out = kernel.flash_attention_masked(
            qq, kk, vv, *indices, skv=Skv, window=mask.window,
            q_offset=mask.q_offset)
    else:
        out = kernel.flash_attention_sparse(
            qq, kk, vv, *indices, skv=Skv, window=mask.window, bq=mask.bq,
            bk=mask.bk, q_offset=mask.q_offset)
    return out[:, :, :Sq]


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len=None,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode: q1 (B, Hq, 1, D) against a (B, Hkv, S, D) cache.

    Arithmetic is prefix-aligned with ``layers.chunked_attention`` (the
    prefill path): operands stream in the cache dtype with f32 products and
    sums, and the narrow cast applies to the UNNORMALIZED ``exp(s - m)``
    (against the row's max over all its visible positions); the f32 PV
    product is divided by the f32 row sum afterwards.  Casting after
    normalizing would quantize another quantity than prefill does and can
    flip near-tie MoE router argmaxes between decode and prefill.
    ``kv_len`` masks the cache tail beyond the current length: an int for
    the whole batch, or a ``(B,)`` int tensor of per-row lengths
    (continuous batching), which moves the window's lower edge per row too.

    A CPU tensor takes the plain version (``ref.decode_attention_ref``); a
    CUDA tensor launches the kernel D1 (``kernel.decode_attention``), whose
    summation order is a function of the row's length, the window and D
    alone, so a row's output does not depend on the batch it is decoded in;
    it raises on a dtype or head dim it lacks."""
    return kernel.decode_attention(q1, k_cache, v_cache, kv_len=kv_len,
                                   window=window)


def decode_attention_max(q1: torch.Tensor, k_shard: torch.Tensor, *,
                         kv_len, window: Optional[int] = None,
                         offset: int = 0) -> torch.Tensor:
    """D1's split mode (a): (B, Hq) f32, each (row, head)'s max score over
    the visible positions of ``k_shard`` (B, Hkv, S, D), which holds
    positions ``offset .. offset + S - 1`` of every row; ``kv_len`` and
    ``window`` are the whole row's; -inf where the shard holds none.  The
    kernel on a CUDA tensor, the plain version on the CPU."""
    return kernel.decode_attention_max(q1, k_shard, kv_len=kv_len,
                                       window=window, offset=offset)


def decode_attention_partial(q1: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, m: torch.Tensor, *,
                             kv_len, window: Optional[int] = None,
                             offset: int = 0):
    """D1's split mode (b): against ``m`` (B, Hq), the max merged over the
    row's shards, this shard's ``acc = sum f32(cast_cache(p)) v`` (B, Hq,
    D) and ``l = sum p`` (B, Hq), f32, ``p = exp(s - m)`` unnormalized and
    rounded to the cache dtype as :func:`decode_attention` rounds it."""
    return kernel.decode_attention_partial(q1, k_shard, v_shard, m,
                                           kv_len=kv_len, window=window,
                                           offset=offset)


def decode_merge(acc: torch.Tensor, l: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The ranks' split-mode partials, ``acc`` (n, B, Hq, D) and ``l`` (n,
    B, Hq) in rank order, summed in that order and divided (f32, IEEE):
    (B, Hq, 1, D) in ``dtype``."""
    return ref.decode_merge(acc, l, dtype)
