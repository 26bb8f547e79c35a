"""gemma2-9b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118] 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.
"""
from repro_torch.configs.base import ModelConfig, ATTN, LOCAL

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    source="arXiv:2408.00118",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    block_pattern=(LOCAL, ATTN),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_kind="gelu",
    tie_embeddings=True,
)
