"""internvl2-1b — VLM: InternViT (stub) + Qwen2-0.5B-class LM backbone.

[arXiv:2404.16821] 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The vision encoder + projector is a STUB: ``input_specs`` provides
precomputed patch embeddings prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    block_pattern=(ATTN,),
    qkv_bias=True,
    frontend="vision",
    num_prefix_embeds=256,   # one image tile worth of patch tokens
    mlp_kind="swiglu",
    tie_embeddings=True,
)
