"""granite-moe-1b-a400m — MoE 32 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (GQA kv=8)
per-expert d_ff=512 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=0,
    vocab_size=49_155,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=32, top_k=8, d_ff=512),
    mlp_kind="swiglu",
    tie_embeddings=True,
)
