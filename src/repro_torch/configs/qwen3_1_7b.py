"""Qwen3-1.7B: dense, qk_norm, GQA. [hf:Qwen/Qwen3-8B family; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144, vocab_size=151936,
    block_unit=("attn",), n_repeats=28, head_dim=128,
    qk_norm=True, mlp_type="swiglu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen3-1.7b-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    block_unit=("attn",), n_repeats=2, head_dim=16, qk_norm=True,
)
