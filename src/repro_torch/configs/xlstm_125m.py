"""xlstm-125m — sLSTM + mLSTM blocks. [arXiv:2405.04517]

12L d_model=768 4H d_ff=0 vocab=50304. Pattern 1 mLSTM : 1 sLSTM.
d_ff=0: xLSTM blocks carry their own up/down projections, no separate FFN.
"""
from repro_torch.configs.base import ModelConfig, MLSTM, SLSTM

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=(MLSTM, SLSTM),
    chunk_size=256,
    norm="layernorm",
)
