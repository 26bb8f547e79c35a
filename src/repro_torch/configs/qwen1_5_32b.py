"""qwen1.5-32b — dense MHA (kv=heads), QKV bias. [hf:Qwen/Qwen1.5-0.5B card]"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152_064,
    block_pattern=(ATTN,),
    qkv_bias=True,
    mlp_kind="swiglu",
)
