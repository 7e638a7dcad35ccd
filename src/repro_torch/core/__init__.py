"""Core of the port: sparse formats, SU stream ops, stencils, block masks
and the precision ladder (the reference's ``repro.core``)."""
from repro_torch.core.formats import (BCSR, CSR, INVALID_KEY, BatchedBCSR,
                                      SortedCOO, banded_sparse,
                                      batched_bcsr_from_dense,
                                      bcsr_from_dense, coo_from_dense,
                                      csr_from_dense, powerlaw_sparse,
                                      random_dense_sparse)
from repro_torch.core.masks import (NEG_INF, AttnMaskSpec, BlockMask,
                                    MaskStream, next_pow2)
from repro_torch.core.precision import LADDER, PrecisionPolicy, policy
from repro_torch.core.stencils import STENCILS, StencilSpec, apply_reference
from repro_torch.core.streams import IndirectStream, StreamSpec
from repro_torch.core.su import (indirect_gather, indirect_scatter_add,
                                 intersect, intersect_dot, topk_sparsify,
                                 union_add)

__all__ = [
    "BCSR", "BatchedBCSR", "CSR", "SortedCOO", "INVALID_KEY",
    "banded_sparse", "batched_bcsr_from_dense", "bcsr_from_dense",
    "coo_from_dense", "csr_from_dense",
    "powerlaw_sparse", "random_dense_sparse",
    "NEG_INF", "AttnMaskSpec", "BlockMask", "MaskStream", "next_pow2",
    "LADDER", "PrecisionPolicy", "policy",
    "STENCILS", "StencilSpec", "apply_reference",
    "IndirectStream", "StreamSpec",
    "indirect_gather", "indirect_scatter_add", "intersect", "intersect_dot",
    "topk_sparsify", "union_add",
]
