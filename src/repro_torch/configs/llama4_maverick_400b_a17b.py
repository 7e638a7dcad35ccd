"""Llama-4 Maverick 400B-A17B: interleaved dense/MoE, 128 routed experts
top-1 + shared expert. [hf:meta-llama/Llama-4-*; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048.

The MoE dispatch path is the paper's SpMM/SU-indirection showcase."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048,
    block_unit=("attn", "attn+moe"), n_repeats=24, head_dim=128,
    n_experts=128, top_k=1, moe_shared_expert=True,
    mlp_type="swiglu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="llama4-maverick-smoke", family="moe",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
    block_unit=("attn", "attn+moe"), n_repeats=2, head_dim=16,
    n_experts=4, top_k=1, moe_shared_expert=True,
    capacity_factor=8.0,
)
