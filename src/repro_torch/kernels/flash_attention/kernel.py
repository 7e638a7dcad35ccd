"""Wrappers of the flash-attention CUDA kernels (``csrc/flash_attention.cu``):
K3 ``flash_attention``, K4m ``flash_attention_masked`` and K4s
``flash_attention_sparse``, the ports of the Pallas kernels of the same
names (repro/kernels/flash_attention/kernel.py), with their signatures minus
``interpret``; and of D1 ``decode_attention`` (``csrc/decode_attention.cu``),
the reference's one-token decode attention (plain array code there) as a
kernel whose summation order is a function of the row alone.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel on the current stream or raises -- there is no fallback.  Each
wrapper counts its launches in ``.launches``.  The kernels take f32 or bf16
q, k, v of one type, head dims 16, 64, 128, 192 or 256, and tiles of at
most 64 x 64 (``kernels.tuning`` row ``flash``); the source picks the path
by type, bf16 on the tensor cores (p kept at f32 precision as a bf16 hi +
lo pair), f32 on the CUDA cores.  D1 takes q f32 or bf16 and a cache f32 or
bf16 (each in its own dtype), the same head dims and GQA groups of at most
16, past 8 in passes of at most 8 heads (one launch; a head's order is the
same in any pass).  D1's split mode, for a cache whose sequence is split
over ranks, is two more entry points of the same kernel:
``decode_attention_max`` (a shard's max a (row, head)) and
``decode_attention_partial`` (its unnormalized sums against the merged
max), each counting its launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.tuning import FLASH_MAX_TILE

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 64, 128, 192, 256)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 8                  # B, Hq, Hkv, Sq, Skv, D, bq, bk
_TAIL = [_I] * 3 + [_F, _I, _P]    # skv, window, q_offset, scale, dtype,
#                                    stream
_ARGTYPES = {
    "flash_attention_launch": [_P] * 4 + _SHAPE + [_I] + _TAIL,  # q k v out
    #                                                           causal
    "flash_attention_masked_launch":                      # q k v kinds out
        [_P] * 5 + _SHAPE + _TAIL,
    "flash_attention_sparse_launch":        # q k v rows cols kinds cap out
        [_P] * 6 + [_I, _P] + _SHAPE + _TAIL,
}


_DECODE_GROUP_MAX = 16    # heads a kv head (ref.DECODE_PASS_HEADS a pass)
# D1's C entry points: the pointers, then the ints (kv_scalar, B, Hq, Hkv,
# S, D, window[, offset]), scale, q_dtype, cache_dtype, stream
_DECODE_TAIL = [_F] + [_I] * 2 + [_P]
_DECODE_ARGTYPES = {
    # q k v out kv_len
    "decode_attention_launch": [_P] * 5 + [_I] * 7 + _DECODE_TAIL,
    # q k m_out kv_len
    "decode_attention_max_launch": [_P] * 4 + [_I] * 8 + _DECODE_TAIL,
    # q k v m acc_out l_out kv_len
    "decode_attention_partial_launch": [_P] * 7 + [_I] * 8 + _DECODE_TAIL,
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _decode_lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    for name, argtypes in _DECODE_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.decode_attention_info.argtypes = [_I] * 3 + [_P]
    lib.decode_attention_info.restype = ctypes.c_int
    return lib


def decode_info(D: int, q_dtype: torch.dtype,
                cache_dtype: torch.dtype) -> dict:
    """D1's launch shape for one instance, read from the built library:
    CTAs a cluster, positions a chunk, threads a CTA, dynamic and static
    shared memory a CTA (bytes), registers a thread and the clusters the
    card holds at once."""
    lib = _decode_lib()
    info = (ctypes.c_int * 7)()
    build.check(lib, lib.decode_attention_info(
        D, _DTYPE_CODE[q_dtype], _DTYPE_CODE[cache_dtype], info),
        "decode_attention info")
    return dict(zip(("cluster", "chunk", "threads", "dynamic_smem",
                     "static_smem", "registers", "resident_clusters"), info))


def _scale(D: int, scale: Optional[float]) -> float:
    return scale if scale is not None else D ** -0.5


def _q_offset(q_offset) -> int:
    return 0 if q_offset is None else int(q_offset)


def _check(what: str, q, k, v, bq: int, bk: int) -> None:
    """Device, type, shape and contiguity checks of a launch."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous() or t.dim() != 4:
            raise ValueError(f"{what}: {name} must be a contiguous 4-d tensor "
                             f"on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v must share one of float32/bfloat16,"
                        f" got {q.dtype}/{k.dtype}/{v.dtype}")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D \
            or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in {_HEAD_DIMS}")
    if not (1 <= bq <= FLASH_MAX_TILE and 1 <= bk <= FLASH_MAX_TILE) \
            or Sq % bq or Skv % bk:
        raise ValueError(f"{what}: tiles ({bq}, {bk}) must be at most "
                         f"{FLASH_MAX_TILE} and divide Sq={Sq}, Skv={Skv}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"{what}: grid out of range B={B} Hq={Hq}")


def _index(t, device) -> torch.Tensor:
    """An int32 index array (numpy or tensor) as a contiguous tensor on
    ``device``."""
    return torch.as_tensor(t).to(device=device, dtype=torch.int32
                                 ).contiguous()


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, bq: int = 128,
                    bk: int = 128, q_offset=None,
                    skv: Optional[int] = None) -> torch.Tensor:
    """K3.  q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); Hq % Hkv == 0 (GQA).
    ``q_offset``: absolute position of q row 0 (default 0).  Sq % bq == 0,
    Skv % bk == 0 after clamping the tiles to the sequences (``ops`` pads);
    ``skv``: the true KV length when k/v are padded (default Skv), keys at
    or past it are masked.  Returns (B, Hq, Sq, D) in q.dtype."""
    Sq, Skv = q.shape[2], k.shape[2]
    bq, bk = min(bq, Sq), min(bk, Skv)
    skv = Skv if skv is None else int(skv)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, bq=bq, bk=bk,
                                       q_offset=_q_offset(q_offset), skv=skv)
    build.refuse_grad("flash_attention", q, k, v)
    _check("flash_attention", q, k, v, bq, bk)
    B, Hq, _, D = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
        k.shape[1], Sq, Skv, D, bq, bk, int(causal), skv,
        -1 if window is None else int(window), _q_offset(q_offset),
        _scale(D, scale), _DTYPE_CODE[q.dtype], _stream(q))
    build.check(lib, err, "flash_attention launch")
    flash_attention.launches += 1
    return out


def flash_attention_masked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           tile_kinds, *, skv: int,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           q_offset=None) -> torch.Tensor:
    """K4m: dense-grid flash over a per-tile kind map; every KV tile is
    stepped, dead tiles (kind < 0) skip compute.  The parity baseline of the
    sparse walk.  q: (B, Hq, Sq_pad, D); k/v: (B, Hkv, Skv_pad, D);
    tile_kinds: (n_q, n_kv) int (``BlockMask.tile_kinds``), whose shape
    gives the tiles; ``skv`` is the true KV length."""
    if q.device.type == "cpu":
        return ref.flash_attention_masked_ref(
            q, k, v, tile_kinds, skv=skv, window=window, scale=scale,
            q_offset=_q_offset(q_offset))
    build.refuse_grad("flash_attention_masked", q, k, v)
    kinds = _index(tile_kinds, q.device)
    n_q, n_kv = kinds.shape
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    if Sq % n_q or Skv % n_kv:
        raise ValueError(f"flash_attention_masked: kind map {(n_q, n_kv)} "
                         f"does not tile ({Sq}, {Skv})")
    bq, bk = Sq // n_q, Skv // n_kv
    _check("flash_attention_masked", q, k, v, bq, bk)
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_masked_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kinds.data_ptr(),
        out.data_ptr(), B, Hq, k.shape[1], Sq, Skv, D, bq, bk, int(skv),
        -1 if window is None else int(window), _q_offset(q_offset),
        _scale(D, scale), _DTYPE_CODE[q.dtype], _stream(q))
    build.check(lib, err, "flash_attention_masked launch")
    flash_attention_masked.launches += 1
    return out


def flash_attention_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           rows, cols, kinds, *, skv: int,
                           window: Optional[int] = None,
                           scale: Optional[float] = None, bq: int = 128,
                           bk: int = 128, q_offset=None) -> torch.Tensor:
    """K4s: flash attention walking a BlockMask's visible-tile stream.
    rows/cols/kinds: (capacity,) int, sorted by (row, col), every q-tile row
    present (``BlockMask.lower()``); q: (B, Hq, Sq_pad, D), Sq_pad % bq ==
    0; k/v: (B, Hkv, Skv_pad, D), Skv_pad % bk == 0; ``skv`` is the true
    KV length."""
    if q.device.type == "cpu":
        return ref.flash_attention_sparse_ref(
            q, k, v, rows, cols, kinds, skv=skv, window=window, scale=scale,
            bq=bq, bk=bk, q_offset=_q_offset(q_offset))
    build.refuse_grad("flash_attention_sparse", q, k, v)
    _check("flash_attention_sparse", q, k, v, bq, bk)
    rows, cols, kinds = (_index(t, q.device) for t in (rows, cols, kinds))
    cap = rows.numel()
    if rows.dim() != 1 or cols.shape != rows.shape \
            or kinds.shape != rows.shape:
        raise ValueError("flash_attention_sparse: rows, cols, kinds must be "
                         "(capacity,)")
    B, Hq, Sq, D = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    err = lib.flash_attention_sparse_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rows.data_ptr(),
        cols.data_ptr(), kinds.data_ptr(), cap, out.data_ptr(), B, Hq,
        k.shape[1], Sq, k.shape[2], D, bq, bk, int(skv),
        -1 if window is None else int(window), _q_offset(q_offset),
        _scale(D, scale), _DTYPE_CODE[q.dtype], _stream(q))
    build.check(lib, err, "flash_attention_sparse launch")
    flash_attention_sparse.launches += 1
    return out


def _decode_checks(what: str, q1, k_cache, v_cache, kv_len):
    """D1's device, type, shape and alignment checks; returns (the (B,)
    int64 lengths on the device or None, the scalar length)."""
    B, Hq, one, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q1.device or not t.is_contiguous() or t.dim() != 4 \
                or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"4-d tensor on {q1.device}, 16-byte aligned")
    if q1.dtype not in _DTYPE_CODE or k_cache.dtype not in _DTYPE_CODE \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"{what}: q {q1.dtype} and cache "
                        f"{k_cache.dtype}/{v_cache.dtype} must be float32 or "
                        "bfloat16, K and V alike")
    if one != 1 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != D or Hq % Hkv:
        raise ValueError(f"{what}: q {tuple(q1.shape)} vs cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if D not in _HEAD_DIMS or Hq // Hkv > _DECODE_GROUP_MAX:
        raise ValueError(f"{what}: head dim {D} not in "
                         f"{_HEAD_DIMS} or GQA group {Hq // Hkv} over "
                         f"{_DECODE_GROUP_MAX}")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"{what}: grid out of range B={B} "
                         f"Hkv={Hkv}")
    lens, scalar = None, S
    if isinstance(kv_len, torch.Tensor):
        if kv_len.numel() != B or kv_len.device != q1.device:
            raise ValueError(f"{what}: kv_len {tuple(kv_len.shape)}"
                             f" on {kv_len.device} for B={B} on {q1.device}")
        lens = kv_len.reshape(B).to(torch.int64).contiguous()
    elif kv_len is not None:
        scalar = int(kv_len)
    return lens, scalar


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len=None,
                     window: Optional[int] = None) -> torch.Tensor:
    """D1.  q1: (B, Hq, 1, D); k_cache / v_cache: (B, Hkv, S, D), Hq % Hkv
    == 0; ``kv_len``: None (every row sees the whole cache), an int, or a
    ``(B,)`` int tensor on q1's device, read by the kernel (no host sync);
    ``window``: the last ``window`` positions before ``kv_len`` only.
    Reads only the visible positions.  Every caller passes ``kv_len >= 1``;
    a row with none visible gives zeros here (the plain version gives the
    mean of V).  Returns (B, Hq, 1, D) in q1.dtype."""
    if q1.device.type == "cpu":
        return ref.decode_attention_ref(q1, k_cache, v_cache, kv_len=kv_len,
                                        window=window)
    build.refuse_grad("decode_attention", q1, k_cache, v_cache)
    lens, scalar = _decode_checks("decode_attention", q1, k_cache, v_cache,
                                  kv_len)
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    q = q1.contiguous()
    out = torch.empty_like(q)
    lib = _decode_lib()
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        None if lens is None else lens.data_ptr(), scalar,
        B, Hq, Hkv, S, D, -1 if window is None else int(window), D ** -0.5,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], _stream(q))
    build.check(lib, err, "decode_attention launch")
    decode_attention.launches += 1
    return out


def _split_args(what: str, q1, k_cache, v_cache, kv_len, window, offset):
    """The checks and the shared tail of a split-mode launch: (q, the
    lengths' pointer, kv_scalar, B, Hq, Hkv, S, D, window, offset, scale,
    q_dtype, cache_dtype, stream)."""
    build.refuse_grad(what, q1, k_cache, v_cache)
    if kv_len is None or int(offset) < 0:
        raise ValueError(f"{what}: the split mode takes the rows' kv_len "
                         f"and an offset >= 0, got {kv_len!r}, {offset}")
    lens, scalar = _decode_checks(what, q1, k_cache, v_cache, kv_len)
    B, Hq, _, D = q1.shape
    _, Hkv, S, _ = k_cache.shape
    q = q1.contiguous()
    return q, (None if lens is None else lens.data_ptr(), scalar, B, Hq,
               Hkv, S, D, -1 if window is None else int(window), int(offset),
               D ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
               _stream(q)), lens


def decode_attention_max(q1: torch.Tensor, k_cache: torch.Tensor, *,
                         kv_len, window: Optional[int] = None,
                         offset: int = 0) -> torch.Tensor:
    """D1's split mode (a).  ``k_cache`` (B, Hkv, S, D) is a shard holding
    positions ``offset .. offset + S - 1`` of every row; ``kv_len`` (an int
    or a ``(B,)`` int tensor on q1's device) and ``window`` are the whole
    row's.  Returns (B, Hq) f32: each (row, head)'s max score over the
    shard's visible positions, -inf where it holds none
    (``ref.decode_split_max_ref`` on the CPU)."""
    if q1.device.type == "cpu":
        return ref.decode_split_max_ref(q1, k_cache, kv_len=kv_len,
                                        window=window, offset=offset)
    q, tail, _lens = _split_args("decode_attention_max", q1, k_cache,
                                 k_cache, kv_len, window, offset)
    m = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    lib = _decode_lib()
    err = lib.decode_attention_max_launch(q.data_ptr(), k_cache.data_ptr(),
                                          m.data_ptr(), *tail)
    build.check(lib, err, "decode_attention_max launch")
    decode_attention_max.launches += 1
    return m


def decode_attention_partial(q1: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, m: torch.Tensor, *,
                             kv_len, window: Optional[int] = None,
                             offset: int = 0):
    """D1's split mode (b): given ``m`` (B, Hq) f32, the max merged over
    every shard of the row, the shard's unnormalized ``acc = sum
    f32(cast_cache(p)) v`` (B, Hq, D) and ``l = sum p`` (B, Hq), f32,
    zeros where it holds no visible position; arguments as
    :func:`decode_attention_max` (``ref.decode_split_partial_ref`` on the
    CPU)."""
    if q1.device.type == "cpu":
        return ref.decode_split_partial_ref(q1, k_cache, v_cache, m,
                                            kv_len=kv_len, window=window,
                                            offset=offset)
    q, tail, _lens = _split_args("decode_attention_partial", q1, k_cache,
                                 v_cache, kv_len, window, offset)
    B, Hq, _, D = q.shape
    if m.shape != (B, Hq) or m.dtype != torch.float32 \
            or m.device != q.device:
        raise ValueError(f"decode_attention_partial: m {tuple(m.shape)} "
                         f"{m.dtype} on {m.device}; want ({B}, {Hq}) f32")
    m = m.contiguous()
    acc = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    l = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    lib = _decode_lib()
    err = lib.decode_attention_partial_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), m.data_ptr(),
        acc.data_ptr(), l.data_ptr(), *tail)
    build.check(lib, err, "decode_attention_partial launch")
    decode_attention_partial.launches += 1
    return acc, l


flash_attention.launches = 0
flash_attention_masked.launches = 0
flash_attention_sparse.launches = 0
decode_attention.launches = 0
decode_attention_max.launches = 0
decode_attention_partial.launches = 0
