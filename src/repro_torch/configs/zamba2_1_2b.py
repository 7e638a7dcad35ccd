"""Zamba2-1.2B: Mamba-2 backbone + one shared attention block applied
periodically. [arXiv:2411.15242; hf] 38L d_model=2048 32H (kv=32, MHA shared
block) d_ff=8192 vocab=32000, ssm_state=64.

38 mamba layers = 2 prologue + 6 repeats x 6; the shared block fires after
every repeat (6 sites), reusing ONE weight set (Zamba's design)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    block_unit=("mamba",) * 6, n_repeats=6, n_prologue=2,
    head_dim=64, shared_attn_every=1,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    mlp_type="swiglu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    block_unit=("mamba",) * 2, n_repeats=2, n_prologue=1,
    head_dim=16, shared_attn_every=1,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv=4,
)
