"""whisper-small — encoder-decoder audio model. [arXiv:2212.04356]

12L (enc) + 12L (dec) d_model=768 12H d_ff=3072 vocab=51865. The
mel-spectrogram + conv frontend is a STUB per the assignment:
``input_specs`` feeds precomputed frame embeddings (batch, frames, d).
"""
from repro_torch.configs.base import ModelConfig, ATTN

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51_865,
    block_pattern=(ATTN,),
    encoder_layers=12,
    frontend="audio",
    mlp_kind="gelu",
    norm="layernorm",
)
