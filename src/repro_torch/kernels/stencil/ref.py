"""Plain PyTorch version of the stencil kernels (K6a / K6b): the
shifted-slice application of ``core.stencils``, the same arithmetic as the
CUDA kernel (f32 coefficients, product then sum, taps in ``offsets`` order),
so the two agree bit for bit.  Used for CPU tensors and by ``chip_smoke.py``
as the kernel's yardstick on the card."""
from __future__ import annotations

import torch

from repro_torch.core.stencils import StencilSpec, apply_reference


def stencil_ref(grid_in: torch.Tensor, spec: StencilSpec) -> torch.Tensor:
    """The valid interior of ``spec`` applied to a halo-carrying grid."""
    return apply_reference(spec, grid_in)
