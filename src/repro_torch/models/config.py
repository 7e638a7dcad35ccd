"""Architecture configuration: one frozen dataclass drives the whole stack.

The port's own copy of the reference ``ArchConfig`` (same fields, same
defaults), so the port never imports the JAX package.  A model is a stack of
*superblocks* (the repeating unit ``block_unit``) repeated ``n_repeats``
times; per-slot params are stacked along the repeat axis.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

LayerKind = str  # attn | attn_local | attn_global | mamba | rwkv | <x>+moe ...


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # stack structure
    block_unit: Tuple[LayerKind, ...]  # the repeating superblock
    n_repeats: int                     # stack = block_unit * n_repeats
    head_dim: Optional[int] = None     # default d_model // n_heads
    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    local_window: Optional[int] = None   # for attn_local layers
    rope_theta: float = 1e6
    # mlp
    mlp_type: str = "swiglu"             # swiglu | squared_relu
    # moe
    n_experts: int = 0
    top_k: int = 1
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False      # Llama-4 style always-on shared expert
    # dispatch backend: "gather" (index-stream gather) or "bcsr" (dispatch
    # matrix as BatchedBCSR through the SpMM kernel)
    moe_dispatch: str = "gather"
    # raise (instead of warn) when the requested dispatch grouping cannot
    # align with the batch dim
    moe_strict_dispatch: bool = False
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    # zamba-style shared block: apply a single shared attention block after
    # every `shared_attn_every` scanned steps (0 = never)
    shared_attn_every: int = 0
    # extra leading layers of kind block_unit[0] outside the main stack
    n_prologue: int = 0
    # frontend stubs: 'none' | 'vision' | 'audio'
    frontend: str = "none"
    frontend_tokens: int = 0             # prepended embedding positions
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # dtype policy name from repro_torch.core.precision
    policy: str = "bf16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 256; logits over the
        padded ids are sliced off in serving."""
        return -(-self.vocab_size // 256) * 256

    @property
    def n_layers(self) -> int:
        return len(self.block_unit) * self.n_repeats + self.n_prologue

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + stacked blocks), the
        reference's formula."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, Hq, Hkv = self.hd, self.n_heads, self.n_kv_heads
        n = V * d * (1 if self.tie_embeddings else 2)
        mlp = (3 if self.mlp_type == "swiglu" else 2) * d * ff
        attn = d * (Hq * hd) + 2 * d * (Hkv * hd) + (Hq * hd) * d
        if self.qkv_bias:
            attn += (Hq + 2 * Hkv) * hd
        per_kind = {"attn": attn + mlp + 2 * d}
        per_kind["attn_local"] = per_kind["attn_global"] = per_kind["attn"]
        moe_ffn = self.n_experts * mlp + d * self.n_experts
        if self.moe_shared_expert:
            moe_ffn += mlp
        per_kind["attn+moe"] = attn + moe_ffn + 2 * d
        d_in = self.ssm_expand * d
        nh = d_in // self.ssm_head_dim
        per_kind["mamba"] = (d * (2 * d_in + 2 * self.ssm_state + nh)
                             + self.ssm_conv * (d_in + 2 * self.ssm_state)
                             + d_in * d + 2 * nh + d_in + d)
        per_kind["rwkv"] = int(d * ff * 2 + d * d * 5 + 2 * d)
        n += sum(per_kind[k] for k in self.block_unit) * self.n_repeats
        n += per_kind[self.block_unit[0]] * self.n_prologue
        if self.shared_attn_every:
            n += per_kind["attn"]      # one shared block, reused
        return int(n)
