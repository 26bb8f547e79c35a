"""LLaMA 65B — the paper's other evaluation model.

Standard LLaMA-65B card: 80L h=8192 64 heads, d_ff=22016 (8/3·h rounded),
s=2048, B=128 in the paper's runs. SwiGLU FFN => the paper's §3.1 point
that LLaMA FFN FLOPs (3 matmuls to 8/3·h) equal GPT-3's 16bsh².
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="llama-65b",
    family="dense",
    source="paper §3.1 (Huang et al. 2024); arXiv:2302.13971",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=64,
    head_dim=128,
    d_ff=22016,
    vocab_size=32_000,
    block_pattern=(ATTN,),
    mlp_kind="swiglu",
)
