"""Nemotron-4-340B: dense, GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.

Head dim 192 and a GQA group of 12: the decode kernel D1 takes the group
in passes of at most 8 heads.  A layer is 3.45 B parameters (6.91 GB of
bf16), so one 80 GB card holds the full width only at reduced depth."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b", family="dense",
    d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728, vocab_size=256000,
    block_unit=("attn",), n_repeats=96, head_dim=192,
    mlp_type="squared_relu", rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="nemotron-4-340b-smoke", family="dense",
    d_model=96, n_heads=6, n_kv_heads=2, d_ff=384, vocab_size=256,
    block_unit=("attn",), n_repeats=2, head_dim=16, mlp_type="squared_relu",
)
