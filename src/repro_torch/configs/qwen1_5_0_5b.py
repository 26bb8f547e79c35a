"""qwen1.5-0.5b — dense MHA, QKV bias. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    block_pattern=(ATTN,),
    qkv_bias=True,
    mlp_kind="swiglu",
    tie_embeddings=True,
)

# Sliding-window variant used to demonstrate the dense-with-SWA long_500k
# path (the base model is full attention and skips long_500k).
import dataclasses
from repro_torch.configs.base import LOCAL

CONFIG_SWA = dataclasses.replace(
    CONFIG,
    name="qwen1.5-0.5b-swa",
    block_pattern=(LOCAL,),
    window_size=4096,
)
