"""FLOPs accounting (paper eq. 1 + general per-architecture counts).

Paper eq. 1 (matmul-only FLOPs of one fwd+bwd pass over micro batch b):
    F = 72 b s l h^2 (1 + s/6h + v/16lh)
The paper shows (§3.1) the same formula covers LLaMA because its three
FFN matmuls to 8/3 h cost 16 b s h^2, identical to GPT-3's 4h FFN.
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN, LOCAL, MLSTM, RGLRU, SLSTM, ModelConfig
from repro_torch.core.notation import Notation


def paper_flops(n: Notation) -> float:
    """Eq. 1: fwd+bwd FLOPs for micro batch b (factor 72 = 24 fwd x 3)."""
    return 72.0 * n.b * n.s * n.l * n.h**2 * (1 + n.s / (6 * n.h) + n.v / (16 * n.l * n.h))


def paper_flops_fwd(n: Notation) -> float:
    """Forward-only share (1/3 of eq. 1 under the bwd = 2x fwd convention)."""
    return paper_flops(n) / 3.0


def stage_flops(n: Notation) -> float:
    """FLOPs of one pipeline stage (l/p layers; the vocab term is charged
    to the last stage in reality — the paper's F_stage uses the uniform
    share, which we mirror)."""
    return paper_flops(n) / n.p


# ---------------------------------------------------------------------------
# General per-architecture matmul FLOPs (for the assigned archs / roofline).
# ---------------------------------------------------------------------------
def layer_flops_fwd(cfg: ModelConfig, kind: str, b: int, s: int) -> float:
    """Forward matmul FLOPs of one layer (global batch slice b, seq s)."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    f = 0.0
    if kind in (ATTN, LOCAL):
        f += 2 * b * s * d * hd * (nq + 2 * nkv)          # qkv proj
        f += 2 * b * s * nq * hd * d                      # out proj
        ctx = min(s, cfg.window_size) if (kind == LOCAL and cfg.window_size) else s
        f += 2 * 2 * b * nq * s * ctx * hd * 0.5          # qk^T and pv, causal half
    elif kind == RGLRU:
        w = cfg.rnn_width
        f += 2 * b * s * (2 * d * w + w * d)              # in_x, in_g, out
        f += 2 * b * s * (2 * w * w)                      # gates wa, wx
    elif kind in (MLSTM, SLSTM):
        f += 2 * b * s * d * nq * hd * 4                  # q,k,v,(og|z...) proj
        f += 2 * b * s * nq * hd * d                      # out proj
        if kind == MLSTM:
            L = cfg.chunk_size
            f += 2 * b * s * nq * (L * hd + 2 * hd * hd)  # intra scores + state
        else:
            f += 2 * b * s * nq * hd * hd * 4             # recurrent R matmuls
    if cfg.moe is not None:
        e = cfg.moe
        f += 2 * b * s * d * e.num_experts                # router
        f += 2 * b * s * e.top_k * e.capacity_factor * 3 * d * e.d_ff
        if e.shared_expert:
            f += 2 * b * s * 3 * d * e.d_ff
    elif cfg.d_ff:
        n_mat = 3 if cfg.mlp_kind == "swiglu" else 2
        f += 2 * b * s * n_mat * d * cfg.d_ff
    return f


def model_flops_fwd(cfg: ModelConfig, b: int, s: int,
                    include_encoder: bool = True) -> float:
    f = sum(layer_flops_fwd(cfg, k, b, s) for k in cfg.layer_kinds())
    if cfg.encoder_layers:
        from repro_torch.models.model import ENCODER_FRAMES
        if include_encoder:
            f += cfg.encoder_layers * layer_flops_fwd(
                cfg, ATTN, b, ENCODER_FRAMES)
        # cross-attn: k/v projected from encoder states per decoder layer
        # (every call in this implementation), + q/o on the decoder side
        f += cfg.num_layers * 2 * b * ENCODER_FRAMES * 2 * cfg.d_model \
            * cfg.num_kv_heads * cfg.head_dim
        f += cfg.num_layers * 2 * b * s * (
            cfg.d_model * cfg.num_heads * cfg.head_dim * 2
            + 2 * cfg.num_heads * ENCODER_FRAMES * cfg.head_dim)
    f += 2 * b * s * cfg.d_model * cfg.vocab_size         # logits
    return f


def d_cross(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    return d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) / 2


def model_flops_train(cfg: ModelConfig, b: int, s: int) -> float:
    """fwd + bwd = 3x fwd (matmul-only convention, as the paper)."""
    return 3.0 * model_flops_fwd(cfg, b, s)


def model_flops_6nd(cfg: ModelConfig, b: int, s: int) -> float:
    """MODEL_FLOPS = 6*N*D with N = active params (MoE: routed top-k only),
    used as the roofline 'useful compute' reference."""
    n_active = cfg.param_count()
    if cfg.moe is not None:
        e = cfg.moe
        routed_all = cfg.num_layers * e.num_experts * 3 * cfg.d_model * e.d_ff
        routed_active = cfg.num_layers * e.top_k * 3 * cfg.d_model * e.d_ff
        n_active = n_active - routed_all + routed_active
    # embeddings don't do matmul work per token; subtract the table
    n_active -= cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n_active += cfg.vocab_size * cfg.d_model  # unembed matmul is real compute
    return 6.0 * n_active * b * s
