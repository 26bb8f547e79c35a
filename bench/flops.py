"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: model FLOPs a token, the flash kernels' least times, and
the H100's published peaks.

Copied from the program's helpers as they stood when the benchmark was
defined, over a configuration file's ``model`` object (a plain dict):

  * ``param_count``: ``repro_torch/configs/base.py`` ``ModelConfig.param_count``,
    attention mixers with a dense or MoE FFN;
  * ``n_active``, ``attn_keys``, ``flops_per_token``: ``chip_smoke.py``
    ``n_active`` / ``attn_keys`` / ``model_flops`` over
    ``repro_torch/core/flops.py`` ``model_flops_6nd``: 6 N_active + 6 sum over
    attention layers of min(s, window) d a token, N_active the parameters
    less the experts a token's router does not pick and the embedding table
    (an untied head kept, a tied table counted once as the head); no
    recomputation counted;
  * ``causal_pairs``, ``attention_bound``, ``bwd_bounds``: ``chip_smoke.py``'s,
    over shapes instead of tensors;
  * ``PEAK_BF16``, ``HBM_BW``: ``repro_torch/core/h100.py`` (NVIDIA's H100
    SXM data sheet, dense bf16, 700 W part).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12   # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12     # bytes/s, HBM3


def _kinds(m: Dict) -> List[str]:
    pat = list(m.get("block_pattern", ["attn"]))
    n = m["num_layers"]
    return (pat * ((n + len(pat) - 1) // len(pat)))[:n]


def head_dim(m: Dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def param_count(m: Dict) -> int:
    d, hd = m["d_model"], head_dim(m)
    nq, nkv = m["num_heads"], m["num_kv_heads"]
    attn = d * hd * (nq + 2 * nkv) + nq * hd * d
    if m.get("qkv_bias"):
        attn += hd * (nq + 2 * nkv)
    moe = m.get("moe")
    ffn = 0
    if moe:
        ffn = d * moe["num_experts"] + moe["num_experts"] * 3 * d * moe["d_ff"]
    elif m.get("d_ff"):
        ffn = (3 if m.get("mlp_kind", "swiglu") == "swiglu" else 2) * d * m["d_ff"]
    total = 0
    for kind in _kinds(m):
        if kind not in ("attn", "local_attn"):
            raise NotImplementedError(f"no FLOP count for a {kind} mixer")
        total += attn + ffn + 2 * d
    total += m["vocab_size"] * d * (1 if m.get("tie_embeddings") else 2)
    return total


def n_active(m: Dict) -> int:
    n = param_count(m)
    moe = m.get("moe")
    if moe:
        per = 3 * m["d_model"] * moe["d_ff"] * m["num_layers"]
        n -= (moe["num_experts"] - moe["top_k"]) * per
    n -= m["vocab_size"] * m["d_model"] * (1 if m.get("tie_embeddings") else 2)
    return n + m["vocab_size"] * m["d_model"]


def attn_keys(m: Dict, seq: int) -> List[int]:
    w = m.get("window_size", 0)
    return [min(seq, w) if kind == "local_attn" and w else seq
            for kind in _kinds(m) if kind in ("attn", "local_attn")]


def flops_per_token(m: Dict, seq: int) -> float:
    return 6.0 * n_active(m) + 6.0 * sum(attn_keys(m, seq)) * m["d_model"]


def causal_pairs(sq: int, sk: int, *, causal: bool = True, window: int = 0,
                 q_offset: int = 0) -> int:
    """(query, key) pairs the masks keep."""
    pairs = 0
    for i in range(sq):
        hi = min(sk, i + q_offset + 1) if causal else sk
        lo = max(0, i + q_offset - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def attention_bound(b: int, sq: int, sk: int, nq: int, nkv: int, hd: int,
                    itemsize: int, *, causal: bool = True, window: int = 0
                    ) -> Tuple[float, str]:
    """Least seconds of one flash forward: the larger of its FLOPs (two
    products of hd MACs a kept pair) over the bf16 peak and its bytes (q, k,
    v and O in the compute dtype, the fp32 LSE, each once) over HBM
    bandwidth. Returns (seconds, "operations" | "bytes")."""
    flops = 4.0 * b * nq * hd * causal_pairs(sq, sk, causal=causal, window=window)
    nbytes = (2 * b * sq * nq * hd + 2 * b * sk * nkv * hd) * itemsize + 4 * b * sq * nq
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / HBM_BW
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bwd_bounds(b: int, sq: int, sk: int, nq: int, nkv: int, hd: int,
               itemsize: int, *, causal: bool = True, window: int = 0
               ) -> Dict[str, Tuple[float, str]]:
    """Least seconds of each backward kernel: dq does 3 products a kept pair
    (S, dP, dS K), dk/dv 4 (S, dP, P^T dO, dS^T Q), 2 hd FLOP each; each
    reads q, k, v, dO, the LSE and D once and writes its outputs once."""
    pair_flops = 2.0 * b * nq * hd * causal_pairs(sq, sk, causal=causal, window=window)
    q, kv = b * sq * nq * hd, b * sk * nkv * hd
    read = (2 * q + 2 * kv) * itemsize + 2 * (b * sq * nq) * 4
    out = {}
    for name, n_products, written in (("dq", 3, q), ("dkv", 4, 2 * kv)):
        t_ops = n_products * pair_flops / PEAK_BF16
        t_bytes = (read + written * itemsize) / HBM_BW
        out[name] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out
