"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent.

[arXiv:2402.19427] (Griffin / RecurrentGemma). 26L d_model=2560 10H
(GQA kv=1) d_ff=7680 vocab=256000, local attention window 2048.
"""
from repro_torch.configs.base import ModelConfig, RGLRU, LOCAL

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, LOCAL),
    window_size=2048,
    rnn_width=2560,
    mlp_kind="swiglu",
    tie_embeddings=True,
)
