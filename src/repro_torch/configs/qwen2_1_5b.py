"""Qwen2-1.5B: dense, GQA kv=2, QKV bias. [arXiv:2407.10671; hf]
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.

SMOKE's head dim of 8 runs on the CPU; the card's kernels take head dims
16, 64, 128, 192 and 256, so a small config served there uses 16."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-1.5b", family="dense",
    d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960, vocab_size=151936,
    block_unit=("attn",), n_repeats=28, head_dim=128,
    qkv_bias=True, mlp_type="swiglu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2-1.5b-smoke", family="dense",
    d_model=48, n_heads=6, n_kv_heads=2, d_ff=96, vocab_size=256,
    block_unit=("attn",), n_repeats=2, head_dim=8, qkv_bias=True,
)
