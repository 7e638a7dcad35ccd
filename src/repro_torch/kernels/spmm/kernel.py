"""Wrapper of the K2 / K2q CUDA kernel (``csrc/spmm_bcsr.cu``): batched
BCSR x dense SpMM, the port of the Pallas ``spmm_bcsr`` (repro/kernels/spmm),
wide and with per-block ``scales`` (the quantized ``_spmm_quant_kernel``).

A CPU tensor takes the plain version (``ref.spmm_bcsr_ref``); a CUDA tensor
launches the kernel on the current stream or raises -- there is no fallback.
``spmm_bcsr.launches`` counts K2 launches and ``spmm_bcsr.quant_launches``
K2q launches, so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.precision import is_narrow
from repro_torch.kernels import build, tuning
from repro_torch.kernels.spmm.ref import spmm_bcsr_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_QUANT_CODE = {torch.float8_e4m3fn: 2, torch.float8_e5m2: 3, torch.int8: 4}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("spmm_bcsr")
    lib.spmm_bcsr_launch.argtypes = _ARGTYPES
    lib.spmm_bcsr_launch.restype = ctypes.c_int
    return lib


def spmm_bcsr(indptr: torch.Tensor, block_cols: torch.Tensor,
              blocks: torch.Tensor, dense: torch.Tensor, *,
              out_dtype: torch.dtype = torch.float32,
              bn: Optional[int] = None,
              scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[b] = A[b] @ dense[b] for a batch of BCSR matrices sharing one
    (row, col)-sorted index stream.

    Args:
      indptr: (gm + 1,) int32 row pointers into the stream.
      block_cols: (nnzb,) int32 block-column of each stream entry.
      blocks: (B, nnzb, bm, bk) f32 or bf16, bm in {8, 16}, bk <= 32; or
        fp8 e4m3 / e5m2 / int8 with ``scales`` (K2q).
      dense: (B, K, N) f32 or bf16 with K a multiple of bk; any N.
      out_dtype: f32 (default, as the reference) or dense's dtype; f32
        only for narrow blocks.
      bn: output columns per thread block, a multiple of
        ``tuning.spmm_col_unit(dense.dtype)`` (one warp of 16-byte vectors:
        128 f32, 256 bf16) and at most 8 of them (256 threads); for narrow
        blocks (K2q) 128 x a power of two as ``tuning.spmm_quant_group``
        says; default: the ``spmm`` row of ``kernels.tuning``, keyed on the
        narrow block dtype when quantized.
      scales: (B, nnzb) f32 per-block dequant scales of narrow blocks;
        each value is used as ``value.float() * scale``.
    Returns:
      (B, gm * bm, N) in ``out_dtype``.
    """
    if dense.device.type == "cpu":
        return spmm_bcsr_ref(indptr, block_cols, blocks, dense,
                             out_dtype=out_dtype, scales=scales)
    build.refuse_grad("spmm_bcsr", blocks, dense, scales)
    B, nnzb, bm, bk = blocks.shape
    gm = indptr.numel() - 1
    quant = scales is not None
    if bn is None:
        bn = tuning.spmm_bn(blocks.dtype if quant else dense.dtype,
                            dense.device)
    if dense.dim() != 3 or dense.shape[0] != B or dense.shape[1] % bk:
        raise ValueError(f"spmm_bcsr: dense {tuple(dense.shape)} does not "
                         f"match blocks {tuple(blocks.shape)}")
    K, N = dense.shape[1], dense.shape[2]
    for name, t in (("indptr", indptr), ("block_cols", block_cols),
                    ("blocks", blocks), ("dense", dense)):
        if t.device != dense.device or not t.is_contiguous():
            raise ValueError(f"spmm_bcsr: {name} must be contiguous on "
                             f"{dense.device}")
    if indptr.dtype != torch.int32 or block_cols.dtype != torch.int32 \
            or block_cols.numel() != nnzb or indptr.dim() != 1:
        raise ValueError("spmm_bcsr: indptr (gm+1,) and block_cols (nnzb,) "
                         "must be int32")
    if quant:
        if not is_narrow(blocks.dtype) or out_dtype != torch.float32 \
                or scales.dtype != torch.float32 \
                or tuple(scales.shape) != (B, nnzb) \
                or scales.device != dense.device \
                or not scales.is_contiguous():
            raise TypeError(
                f"spmm_bcsr: scales {tuple(scales.shape)} {scales.dtype} "
                f"with blocks {blocks.dtype} -> {out_dtype}: K2q takes "
                f"narrow blocks, contiguous (B, nnzb) f32 scales on "
                f"{dense.device} and an f32 output")
        a_code = _QUANT_CODE[blocks.dtype]
    elif blocks.dtype in _DTYPE_CODE:
        a_code = _DTYPE_CODE[blocks.dtype]
    else:
        raise TypeError(f"spmm_bcsr: {blocks.dtype} blocks need scales")
    if dense.dtype not in _DTYPE_CODE \
            or out_dtype not in (dense.dtype, torch.float32):
        raise TypeError(f"spmm_bcsr: unsupported dtypes blocks={blocks.dtype}"
                        f" dense={dense.dtype} out={out_dtype}")
    if quant:
        tuning.spmm_quant_group(bm, bk, bn, dense.dtype)
    else:
        unit = tuning.spmm_col_unit(dense.dtype)
        if bm not in (8, 16) or not 1 <= bk <= 32 or bn % unit \
                or not unit <= bn <= 8 * unit:
            raise ValueError(
                f"spmm_bcsr: unsupported tile bm={bm} bk={bk} bn={bn} (bn "
                f"must be a multiple of {unit}, at most {8 * unit}, for "
                f"{dense.dtype} dense)")
    if not (1 <= gm <= 65535 and 1 <= B <= 65535 and N >= 1):
        raise ValueError(f"spmm_bcsr: grid out of range gm={gm} B={B} N={N}")
    out = torch.empty((B, gm * bm, N), dtype=out_dtype, device=dense.device)
    lib = _lib()
    err = lib.spmm_bcsr_launch(
        indptr.data_ptr(), block_cols.data_ptr(), blocks.data_ptr(),
        scales.data_ptr() if quant else None, dense.data_ptr(),
        out.data_ptr(), B, gm, nnzb, bm, bk, K, N, bn, a_code,
        _DTYPE_CODE[dense.dtype], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(dense.device).cuda_stream)
    build.check(lib, err, "spmm_bcsr launch")
    if quant:
        spmm_bcsr.quant_launches += 1
    else:
        spmm_bcsr.launches += 1
    return out


spmm_bcsr.launches = 0
spmm_bcsr.quant_launches = 0
