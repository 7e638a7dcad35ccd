"""InternVL2-26B: InternViT frontend (stub) + InternLM2 decoder backbone.
[arXiv:2404.16821; hf] 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553. The vision frontend is a stub: a caller passes precomputed
patch embeddings (B, 256, d), which the model prepends to the text tokens'
embeddings (``model.prefill(embeddings=)``)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92553,
    block_unit=("attn",), n_repeats=48, head_dim=128,
    mlp_type="swiglu", rope_theta=1e6,
    frontend="vision", frontend_tokens=256,
)

SMOKE = ArchConfig(
    name="internvl2-26b-smoke", family="vlm",
    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=277,
    block_unit=("attn",), n_repeats=2, head_dim=16,
    mlp_type="swiglu", frontend="vision", frontend_tokens=8,
)
