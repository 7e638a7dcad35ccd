"""MusicGen-large: decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32, MHA) d_ff=8192
vocab=2048. The EnCodec audio frontend is a stub: a caller passes
precomputed conditioning frame embeddings (B, 64, d), which the model
prepends to the code tokens' embeddings (``model.prefill(embeddings=)``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
    block_unit=("attn",), n_repeats=48, head_dim=64,
    mlp_type="swiglu", rope_theta=1e4,
    frontend="audio", frontend_tokens=64,
)

SMOKE = ArchConfig(
    name="musicgen-large-smoke", family="audio",
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=128,
    block_unit=("attn",), n_repeats=2, head_dim=16,
    frontend="audio", frontend_tokens=4,
)
