"""GPT-3 96B — the paper's own evaluation model (paper Table 2).

h=9984 a=104 s=2048 l=80 B=128, vocab ~51200 (GPT-2 BPE padded).
GELU FFN with d_ff = 4h, learned-position-free (we use RoPE as the
positional scheme; the paper's analysis is positional-scheme agnostic).
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="gpt3-96b",
    family="dense",
    source="paper Table 2 (Huang et al. 2024)",
    num_layers=80,
    d_model=9984,
    num_heads=104,
    num_kv_heads=104,
    head_dim=96,
    d_ff=4 * 9984,
    vocab_size=51_200,
    block_pattern=(ATTN,),
    mlp_kind="gelu",
    norm="layernorm",
    qkv_bias=True,
)
