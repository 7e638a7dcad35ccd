"""RWKV-6 (Finch) 7B: attention-free, data-dependent per-channel decay.
[arXiv:2404.05892; hf] 32L d_model=4096 d_ff=14336 vocab=65536."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    d_model=4096, n_heads=64, n_kv_heads=64, d_ff=14336, vocab_size=65536,
    block_unit=("rwkv",), n_repeats=32, head_dim=64,
    mlp_type="squared_relu",
)

SMOKE = ArchConfig(
    name="rwkv6-7b-smoke", family="ssm",
    d_model=128, n_heads=2, n_kv_heads=2, d_ff=448, vocab_size=256,
    block_unit=("rwkv",), n_repeats=2, head_dim=64,
    mlp_type="squared_relu",
)
