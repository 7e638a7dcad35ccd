"""Public stencil API (``repro/kernels/stencil/ops.py``): dispatch to K6a /
K6b.  The reference pads the interior to whole tiles and slices the result;
the port's kernel bounds-checks the ragged edge instead, so no tile changes
the result."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.stencils import StencilSpec
from repro_torch import as_tensor
from repro_torch.kernels.stencil.kernel import stencil_2d, stencil_3d


def apply(grid_in, spec: StencilSpec, *,
          tile: Optional[Tuple[int, ...]] = None, device=None
          ) -> torch.Tensor:
    """Apply ``spec`` to a halo-carrying grid (interior + 2 * radius per
    dim); returns the interior.

    ``grid_in`` is a tensor, which runs where it lies, or a numpy array,
    which goes to ``device`` (default ``"cuda"``).  ``tile`` defaults to
    the ``stencil2d`` / ``stencil3d`` row of ``kernels.tuning``."""
    grid = as_tensor(grid_in, device)
    if grid.dim() != spec.ndim:
        raise ValueError(f"apply: {spec.name} is {spec.ndim}-D, grid is "
                         f"{tuple(grid.shape)}")
    fn = stencil_2d if spec.ndim == 2 else stencil_3d
    return fn(grid.contiguous(), spec, tile=tile)


def flops(spec: StencilSpec, interior: Tuple[int, ...]) -> int:
    """FLOPs of one application (2 per tap per point, the paper's
    convention)."""
    n = 1
    for s in interior:
        n *= s
    return n * spec.flops_per_point()
