"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert) vocab=202048, early-fusion multimodal (frontend
stubbed per assignment; text path exercised here).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, ATTN

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,  # all FFN capacity is in the MoE
    vocab_size=202_048,
    block_pattern=(ATTN,),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff=8192, shared_expert=True),
    mlp_kind="swiglu",
)
