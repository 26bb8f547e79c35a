"""qwen3-14b — dense, GQA kv=8, qk-norm. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
)
