"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``. The layer
stack is described by ``block_pattern`` — a repeating tuple of sublayer
kinds — so heterogeneous stacks (gemma2 local/global alternation,
recurrentgemma's RGLRU:attn 2:1, xLSTM's mLSTM/sLSTM mix) all flow
through one scan-based implementation (models/blocks.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Sublayer kinds usable in block_pattern. Each entry denotes the temporal
# mixer of one layer; an FFN (dense or MoE per config) follows each layer
# unless d_ff == 0.
ATTN = "attn"            # global causal attention
LOCAL = "local_attn"     # sliding-window causal attention
RGLRU = "rglru"          # Griffin-style gated linear recurrent unit block
MLSTM = "mlstm"          # xLSTM matrix-memory cell (chunkwise parallel)
SLSTM = "slstm"          # xLSTM scalar-memory cell (sequential scan)

MIXER_KINDS = (ATTN, LOCAL, RGLRU, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    shared_expert: bool = False    # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    source: str                    # citation for the configuration
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense FFN hidden (0 = no FFN)
    vocab_size: int

    head_dim: int = 0              # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = (ATTN,)

    # --- attention options -------------------------------------------------
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: float = 0.0      # gemma2 attention-logit softcap
    final_softcap: float = 0.0     # gemma2 final-logit softcap
    window_size: int = 0           # sliding window for LOCAL layers
    rope_theta: float = 10_000.0
    attn_impl: str = "reference"   # reference | recompute | flash

    # --- FFN / MoE ----------------------------------------------------------
    mlp_kind: str = "swiglu"       # swiglu | gelu
    moe: Optional[MoEConfig] = None

    # --- recurrent (RG-LRU / xLSTM) ------------------------------------------
    rnn_width: int = 0             # RG-LRU recurrent width (0 -> d_model)
    conv_width: int = 4            # temporal conv width in recurrent blocks
    chunk_size: int = 256          # mLSTM chunkwise block length

    # --- enc-dec / modality frontend -----------------------------------------
    encoder_layers: int = 0        # >0 => encoder-decoder (whisper)
    frontend: str = "none"         # none | audio | vision (stub embeddings)
    num_prefix_embeds: int = 0     # vision patch tokens prepended (vlm)

    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False

    # --- lowering strategy -----------------------------------------------------
    # scan_blocks=True iterates pattern blocks with lax.scan (O(1) HLO in
    # depth). False unrolls them — used by launch/roofline.py to extract
    # exact per-block cost terms (XLA cost_analysis counts a scan body once).
    scan_blocks: bool = True

    # --- perf levers (EXPERIMENTS.md §Perf; defaults = paper-faithful baseline)
    # fused_xent: masked-reduce cross-entropy that never gathers the
    # vocab-sharded logits (vs. baseline take_along_axis gather).
    fused_xent: bool = False
    # constrain MoE dispatch buffers to (batch->data, experts->model) so
    # GSPMD lowers one clean all-to-all instead of gather chains.
    moe_constrained: bool = False
    # attention score/softmax precision: True = fp32 (paper-faithful:
    # its exp-(7) chain is exactly this upcast); False = bf16 scores
    # (halves the s^2 HBM traffic; production systems do this when the
    # flash kernel isn't in play).
    attn_fp32: bool = True

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rnn_width == 0:
            object.__setattr__(self, "rnn_width", self.d_model)
        for k in self.block_pattern:
            assert k in MIXER_KINDS, k
        assert self.num_heads % self.num_kv_heads == 0, (
            self.num_heads, self.num_kv_heads)

    # ---- derived ------------------------------------------------------------
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """The mixer kind of every (decoder) layer, pattern repeated."""
        pat = self.block_pattern
        reps = (self.num_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.num_layers])

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer does *global* attention over the full sequence
        (the assignment's criterion for running long_500k)."""
        return ATTN not in self.layer_kinds()

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        attn = d * hd * (n_q + 2 * n_kv) + n_q * hd * d
        if self.qkv_bias:
            attn += hd * (n_q + 2 * n_kv)
        ffn_dense = 0
        if self.d_ff:
            ffn_dense = (3 if self.mlp_kind == "swiglu" else 2) * d * self.d_ff
        rglru = 0
        if RGLRU in self.block_pattern:
            w = self.rnn_width
            rglru = 2 * d * w + w * d + self.conv_width * w + 2 * w * w + 2 * w
        total = 0
        for kind in self.layer_kinds():
            if kind in (ATTN, LOCAL):
                total += attn
            elif kind == RGLRU:
                total += rglru
            elif kind in (MLSTM, SLSTM):
                total += 4 * d * n_q * hd + n_q * hd * d + 3 * n_q * hd
            if self.moe is not None:
                e = self.moe
                total += d * e.num_experts  # router
                total += e.num_experts * 3 * d * e.d_ff
                if e.shared_expert:
                    total += 3 * d * e.d_ff
            elif self.d_ff:
                total += ffn_dense
            total += 2 * d  # norms
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            total += self.encoder_layers * (attn + ffn_dense + 2 * d)
            total += self.num_layers * (attn + 2 * d)  # cross-attn in decoder
        return total

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-scale variant of the same family (<=2 layers,
        d_model<=512, <=4 experts), per the assignment."""
        pat = self.block_pattern
        n_layers = max(len(pat), 2)
        d_model = min(self.d_model, 256)
        n_heads = min(self.num_heads, 4)
        n_kv = max(1, min(self.num_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        # Families with a decoupled head_dim (gemma2-style wide heads:
        # head_dim != d_model/num_heads) keep their width *ratio* at
        # smoke scale — rebinding to d_model//n_heads silently changed
        # what shape family the smoke test exercises. Rounded to the
        # nearest even width: RoPE splits the head in half.
        head_dim = d_model // n_heads
        if self.head_dim * self.num_heads != self.d_model:
            ratio = self.head_dim * self.num_heads / self.d_model
            head_dim = max(2, 2 * round(head_dim * ratio / 2))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff=128)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=n_layers,
            d_model=d_model,
            num_heads=n_heads,
            num_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=0 if self.d_ff == 0 else 2 * d_model,
            vocab_size=min(self.vocab_size, 512),
            rnn_width=0 if self.rnn_width == self.d_model else min(self.rnn_width, d_model),
            window_size=min(self.window_size, 32) if self.window_size else 0,
            chunk_size=16,
            moe=moe,
            encoder_layers=2 if self.encoder_layers else 0,
            num_prefix_embeds=min(self.num_prefix_embeds, 4),
        )
        kw.update(overrides)
        new = dataclasses.replace(self, **kw)
        object.__setattr__(new, "rnn_width", kw["rnn_width"] or d_model)
        return new


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run-level configuration (paper notation: B, b, p, t)."""
    global_batch: int = 128
    micro_batch: int = 1            # paper's `b`
    seq_len: int = 2048             # paper's `s`
    pp: int = 8                     # paper's `p` (pipeline stages)
    tp: int = 4                     # paper's `t` (tensor parallel)
    dp: int = 1
    schedule: str = "1f1b"          # gpipe | 1f1b | bpipe
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    steps: int = 300
    seed: int = 0
    remat: str = "none"             # none | attn | full  (paper's recompute arms)
