"""Wrapper of the K2 CUDA kernel (``csrc/spmm_bcsr.cu``): batched BCSR x
dense SpMM, the port of the Pallas ``spmm_bcsr`` (repro/kernels/spmm).

A CPU tensor takes the plain version (``ref.spmm_bcsr_ref``); a CUDA tensor
launches the kernel on the current stream or raises -- there is no fallback.
``spmm_bcsr.launches`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, tuning
from repro_torch.kernels.spmm.ref import spmm_bcsr_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("spmm_bcsr")
    lib.spmm_bcsr_launch.argtypes = _ARGTYPES
    lib.spmm_bcsr_launch.restype = ctypes.c_int
    return lib


def spmm_bcsr(indptr: torch.Tensor, block_cols: torch.Tensor,
              blocks: torch.Tensor, dense: torch.Tensor, *,
              out_dtype: Optional[torch.dtype] = None,
              bn: Optional[int] = None,
              scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C[b] = A[b] @ dense[b] for a batch of BCSR matrices sharing one
    (row, col)-sorted index stream.

    Args:
      indptr: (gm + 1,) int32 row pointers into the stream.
      block_cols: (nnzb,) int32 block-column of each stream entry.
      blocks: (B, nnzb, bm, bk) f32 or bf16, bm in {8, 16}, bk <= 32.
      dense: (B, K, N) f32 or bf16 with K a multiple of bk; any N.
      out_dtype: dense's dtype (default) or f32.
      bn: output columns per thread block (a multiple of 32, <= 1024);
        default: the ``spmm`` row of ``kernels.tuning``.
      scales: per-block dequant scales -- not supported yet (K2q).
    Returns:
      (B, gm * bm, N) in ``out_dtype``.
    """
    if scales is not None:
        raise NotImplementedError(
            "spmm_bcsr: per-block scales (the quantized K2q variant) are not "
            "ported yet")
    out_dtype = dense.dtype if out_dtype is None else out_dtype
    if dense.device.type == "cpu":
        return spmm_bcsr_ref(indptr, block_cols, blocks, dense,
                             out_dtype=out_dtype)
    B, nnzb, bm, bk = blocks.shape
    gm = indptr.numel() - 1
    bn = tuning.spmm_bn(dense.dtype, dense.device) if bn is None else bn
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
    if blocks.dtype not in _DTYPE_CODE or dense.dtype not in _DTYPE_CODE \
            or out_dtype not in (dense.dtype, torch.float32):
        raise TypeError(f"spmm_bcsr: unsupported dtypes blocks={blocks.dtype}"
                        f" dense={dense.dtype} out={out_dtype}")
    if bm not in (8, 16) or not 1 <= bk <= 32 or bn % 32 or not 32 <= bn <= 1024:
        raise ValueError(f"spmm_bcsr: unsupported tile bm={bm} bk={bk} bn={bn}")
    if not (1 <= gm <= 65535 and 1 <= B <= 65535 and N >= 1):
        raise ValueError(f"spmm_bcsr: grid out of range gm={gm} B={B} N={N}")
    out = torch.empty((B, gm * bm, N), dtype=out_dtype, device=dense.device)
    lib = _lib()
    err = lib.spmm_bcsr_launch(
        indptr.data_ptr(), block_cols.data_ptr(), blocks.data_ptr(),
        dense.data_ptr(), out.data_ptr(), B, gm, nnzb, bm, bk, K, N, bn,
        _DTYPE_CODE[blocks.dtype], _DTYPE_CODE[dense.dtype],
        _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(dense.device).cuda_stream)
    build.check(lib, err, "spmm_bcsr launch")
    spmm_bcsr.launches += 1
    return out


spmm_bcsr.launches = 0
