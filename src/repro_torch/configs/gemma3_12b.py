"""Gemma3-12B: 5:1 local:global attention, 128k context.
[hf:google/gemma-3-* family; unverified] 48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144, sliding window 1024 on local layers.

Local layers decode against ring-buffer caches bounded by the window;
global layers against the full cache."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense",
    d_model=3840, n_heads=16, n_kv_heads=8, d_ff=15360, vocab_size=262144,
    block_unit=("attn_local",) * 5 + ("attn_global",), n_repeats=8,
    head_dim=256, qk_norm=True, local_window=1024,
    mlp_type="swiglu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke", family="dense",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    block_unit=("attn_local",) * 2 + ("attn_global",), n_repeats=2,
    head_dim=16, qk_norm=True, local_window=16,
)
