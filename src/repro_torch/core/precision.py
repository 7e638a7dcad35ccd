"""Precision policy and BlockQuant: the port of ``repro/core/precision.py``.

``policy()`` names (param, compute, accum) dtype triples; matmuls take their
operands in the compute dtype and accumulate in the accum dtype (f32).

BlockQuant is per-block-scaled narrow storage (fp8 e4m3 / e5m2 / int8) with
one f32 scale per block, row or slice.  The dequant contract is
``values.float() * scale`` -- exactly that expression, in that order -- so a
kernel that applies the scale as it loads a value (``__fmul_rn(float(q),
scale)``) is bit-identical to dequantizing on the host and running the f32
kernel.  With nearest rounding the quantized bytes and scales equal the
reference's: the scale is ``amax / qmax`` in f32 (1.0 for an all-zero
block), values are divided by it in f32, clipped to +/-``qmax`` (torch's
fp8 casts turn overflow into NaN, so the clip comes first), and rounded to
nearest even (``torch.round`` for int8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

LADDER: Dict[str, torch.dtype] = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """param/compute/accum dtype triple with widening accumulation."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32


def policy(name: str = "bf16") -> PrecisionPolicy:
    """Named policies for the ladder; ``name`` is the compute dtype."""
    return PrecisionPolicy(param_dtype=torch.float32,
                           compute_dtype=LADDER[name],
                           accum_dtype=torch.float32)


def widening_sum_dot(a: torch.Tensor, b: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ExSdotp analogue: narrow pairs widened, multiplied and summed over
    the last axis in ``out_dtype``."""
    return (a.to(out_dtype) * b.to(out_dtype)).sum(dim=-1)


# ---------------------------------------------------------------------------
# BlockQuant
# ---------------------------------------------------------------------------

QUANT_DTYPES: Dict[str, torch.dtype] = {
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
}

# Largest magnitude of each narrow format (int8 is symmetric: +/-127).
QUANT_MAX: Dict[str, float] = {
    "fp8_e4m3": 448.0,
    "fp8_e5m2": 57344.0,
    "int8": 127.0,
}

# f32 mantissa bits dropped when truncating to each narrow float: the width
# of the stochastic-rounding dither.
_SR_DROP_BITS = {"fp8_e4m3": 23 - 3, "fp8_e5m2": 23 - 2}

# Saturation clamp: below f32max with headroom, so qmax * (SAT_MAX / qmax)
# stays finite after the scale's rounding.
_SAT_MAX = 3.0e38

Noise = Union[torch.Tensor, np.ndarray]


def quant_name(dtype) -> Optional[str]:
    """Narrow storage dtype -> ladder name (None if wide)."""
    for name, q in QUANT_DTYPES.items():
        if dtype == q:
            return name
    return None


def is_narrow(dtype) -> bool:
    """True for 1-byte block-value dtypes (fp8 variants / int8)."""
    return quant_name(dtype) is not None


def _resolve_quant(dtype) -> Tuple[str, torch.dtype, float]:
    if isinstance(dtype, str):
        if dtype not in QUANT_DTYPES:
            raise ValueError(f"unknown quant dtype {dtype!r}; "
                             f"choose from {sorted(QUANT_DTYPES)}")
        name = dtype
    else:
        name = quant_name(dtype)
        if name is None:
            raise ValueError(f"{dtype} is not a narrow quant dtype; "
                             f"choose from {sorted(QUANT_DTYPES)}")
    return name, QUANT_DTYPES[name], QUANT_MAX[name]


def _generator(seed: int, salt: int, device) -> torch.Generator:
    """An explicit generator seeded from ``(seed, salt)`` only: no global
    state, so the same seed gives the same bits on every call."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + int(salt)) % 2**63)
    return g


def _noise(noise: Noise, shape, dtype: torch.dtype, device) -> torch.Tensor:
    n = torch.from_numpy(np.array(noise)) if isinstance(
        noise, np.ndarray) else noise
    if tuple(n.shape) != tuple(shape):
        raise ValueError(f"noise shape {tuple(n.shape)} != {tuple(shape)}")
    return n.to(device=device, dtype=dtype)


def stochastic_round(x: torch.Tensor, dtype, *, seed: int = 0, salt: int = 0,
                     noise: Optional[Noise] = None) -> torch.Tensor:
    """Stochastically round ``x`` (f32) to a narrow dtype, deterministically.

    Float targets add uniform random bits below the target mantissa to the
    magnitude's bit pattern and truncate, so a value rounds up with
    probability equal to its fractional distance; int8 adds a uniform
    [0, 1) and floors.

    ``noise`` supplies the randomness: uint32 dither bits (taken modulo the
    dropped width) for the fp8 targets, f32 uniforms in [0, 1) for int8, of
    ``x``'s shape.  Given the reference's own draw (``jax.random.bits`` /
    ``jax.random.uniform`` of ``fold_in(PRNGKey(seed), salt)``), the result
    equals the reference's bit for bit.  Without it the noise comes from a
    ``torch.Generator`` seeded from ``(seed, salt)``: deterministic across
    calls, but not the reference's bits.
    """
    name, qdtype, qmax = _resolve_quant(dtype)
    x = x.float().clamp(-qmax, qmax)
    if name == "int8":
        u = (_noise(noise, x.shape, torch.float32, x.device)
             if noise is not None else
             torch.rand(x.shape, generator=_generator(seed, salt, x.device),
                        device=x.device))
        return torch.floor(x + u).clamp(-127, 127).to(torch.int8)
    drop = _SR_DROP_BITS[name]
    if noise is not None:
        dither = _noise(noise, x.shape, torch.int64, x.device) % (1 << drop)
    else:
        dither = torch.randint(0, 1 << drop, x.shape, device=x.device,
                               generator=_generator(seed, salt, x.device))
    # |x| <= 57344 has bit pattern < 0x47700000, so adding < 2**21 stays
    # inside int32
    bits = x.abs().view(torch.int32) + dither.to(torch.int32)
    mag = (bits & ~((1 << drop) - 1)).view(torch.float32)
    y = torch.where(torch.signbit(x), -mag, mag)
    # truncated magnitudes are representable (bar the clip at qmax, which
    # the re-clip restores), so the cast cannot round again
    return y.clamp(-qmax, qmax).to(qdtype)


def _round_to(x: torch.Tensor, dtype, rounding: str, seed: int,
              noise: Optional[Noise]) -> torch.Tensor:
    """Round pre-scaled f32 values into the narrow grid."""
    name, qdtype, qmax = _resolve_quant(dtype)
    if rounding == "stochastic":
        return stochastic_round(x, name, seed=seed, noise=noise)
    if rounding != "nearest":
        raise ValueError(f"rounding must be 'nearest' or 'stochastic', "
                         f"got {rounding!r}")
    x = x.float().clamp(-qmax, qmax)
    if name == "int8":
        return torch.round(x).clamp(-127, 127).to(torch.int8)
    return x.to(qdtype)                 # round to nearest even


def _amax_scale(x: torch.Tensor, dims, qmax: float) -> torch.Tensor:
    """``amax / qmax`` (1.0 where amax is 0).  The divisor is a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its rounded
    reciprocal, which is not the reference's correctly rounded quotient."""
    amax = x.abs().amax(dim=dims)
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def _guard_nonfinite(x: torch.Tensor, who: str, saturate: bool
                     ) -> torch.Tensor:
    """A non-finite input would give a non-finite (or, for NaN, a unit)
    scale and poison the quantized stream silently.  ``saturate=True``
    clamps deterministically (NaN -> 0, +/-Inf -> +/-3e38); otherwise a
    non-finite input raises ``FloatingPointError`` (on the card this reads
    one flag back to the host)."""
    if saturate:
        return torch.where(torch.isnan(x), torch.zeros_like(x),
                           x.clamp(-_SAT_MAX, _SAT_MAX))
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(
            f"{who}: non-finite input would produce a non-finite amax scale "
            f"and poison the quantized stream; pass saturate=True to clamp "
            f"deterministically instead")
    return x


def quantize_blocks(blocks: torch.Tensor, dtype, *,
                    rounding: str = "nearest", seed: int = 0,
                    saturate: bool = False, noise: Optional[Noise] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric quantization of a ``(..., nnzb, bm, bn)`` stream:
    one f32 scale per (bm, bn) block, ``max|block| / qmax`` (1.0 for an
    all-zero block).  Returns ``(values, scales)`` with ``scales.shape ==
    blocks.shape[:-2]``.  ``noise``: see :func:`stochastic_round`."""
    x = _guard_nonfinite(blocks.float(), "quantize_blocks", saturate)
    _, _, qmax = _resolve_quant(dtype)
    scales = _amax_scale(x, (-2, -1), qmax)
    q = _round_to(x / scales[..., None, None], dtype, rounding, seed, noise)
    return q, scales


def dequantize_blocks(values: torch.Tensor, scales: torch.Tensor
                      ) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: ``values.float() * scale`` -- the
    expression the quantized kernels compute per value as they load it."""
    return values.float() * scales[..., None, None].float()


def quantize_rows(vals: torch.Tensor, dtype, *, rounding: str = "nearest",
                  seed: int = 0, saturate: bool = False,
                  noise: Optional[Noise] = None, check: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row quantization over the last axis (ELL row streams, KV time
    slices).  Returns ``(values, scales)`` with ``scales.shape ==
    vals.shape[:-1]``.  ``check=False`` skips the non-finite check (and
    its read back to the host), as the reference's check is skipped under
    jit: the serving path's KV quantization, which a CUDA graph captures,
    runs so."""
    x = vals.float()
    if check or saturate:
        x = _guard_nonfinite(x, "quantize_rows", saturate)
    _, _, qmax = _resolve_quant(dtype)
    scales = _amax_scale(x, -1, qmax)
    q = _round_to(x / scales[..., None], dtype, rounding, seed, noise)
    return q, scales


def dequantize_rows(values: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (same op-order contract)."""
    return (values.float() * scales[..., None].float()).to(dtype)


@dataclasses.dataclass(frozen=True)
class QuantTensor:
    """A dense tensor stored as narrow values + f32 scales over ``axis``
    (kept as given, so a negative axis stays on the same trailing dim when
    leading dims are stripped)."""

    values: torch.Tensor   # narrow storage (fp8 / int8)
    scales: torch.Tensor   # f32, values.shape with ``axis`` removed
    axis: int

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.dim()

    @property
    def dtype(self):
        return self.values.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        s = self.scales.unsqueeze(self.axis)
        return (self.values.float() * s.float()).to(dtype)


def quantize_tensor(x: torch.Tensor, dtype, *, axis: int = -1,
                    rounding: str = "nearest", seed: int = 0,
                    saturate: bool = False, noise: Optional[Noise] = None
                    ) -> QuantTensor:
    """Quantize a dense tensor with one scale per slice along ``axis``."""
    if not -x.dim() <= axis < x.dim():
        raise ValueError(f"quantize_tensor: axis {axis} out of range for "
                         f"ndim {x.dim()}")
    xf = _guard_nonfinite(x.float(), "quantize_tensor", saturate)
    _, _, qmax = _resolve_quant(dtype)
    scales = _amax_scale(xf, axis, qmax)
    q = _round_to(xf / scales.unsqueeze(axis), dtype, rounding, seed, noise)
    return QuantTensor(values=q, scales=scales, axis=axis)
