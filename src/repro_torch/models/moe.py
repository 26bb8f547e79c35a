"""Mixture-of-Experts FFN: top-k router + capacity-bounded scatter dispatch.
The twin of the JAX package's ``repro/models/moe.py``.

Each (token, choice) pair takes the next free slot of its expert's buffer
within its batch row (a cumsum over the row); pairs past the capacity C go
to a drop bin and add nothing. The experts run as batched products over
the buffer, and the outputs are gathered back and weighted by the router's
gates. The buffer is laid out expert-major, (E, b, C, d), with one shared
drop row after it, so the expert products are one ``cast_bmm`` each over a
view; the values kept are the twin's (b, E, C + 1, d) buffer's. A profiler
sees the router and the scatter as the range "moe_dispatch", the gather
and the gate sum as "moe_combine" (their backwards as ``IndexPutBackward0``
and ``IndexSelectBackward0``).

Each pair's slot is a cumsum over the row's pairs, taken along the last
dim of an (b, E, s*k) one-hot, where a GPU scans each expert's row in
parallel (along a middle dim it scans each column serially). The scatter
writes every dropped pair to the same drop row, in an order a GPU does not
fix; that row is cut off before the products and reads 0 in the gather, so
no value kept depends on the order. The gather is an ``index_select``,
whose backward adds into the rows with atomics (advanced indexing's
backward sorts the indices first, and the many dropped pairs on one row
made that the slowest kernel of a training step on an H100); each kept row
is read once, so only the discarded drop row takes more than one add.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.models.layers import _winit, cast_bmm, cast_matmul


def init_moe(gen, cfg, device):
    d, e = cfg.d_model, cfg.moe
    p = {
        "router": _winit(gen, (d, e.num_experts), d, device),
        "wi": _winit(gen, (e.num_experts, d, e.d_ff), d, device),
        "wg": _winit(gen, (e.num_experts, d, e.d_ff), d, device),
        "wo": _winit(gen, (e.num_experts, e.d_ff, d), e.d_ff, device),
    }
    if e.shared_expert:
        p["shared"] = {
            "wi": _winit(gen, (d, e.d_ff), d, device),
            "wg": _winit(gen, (d, e.d_ff), d, device),
            "wo": _winit(gen, (e.d_ff, d), e.d_ff, device),
        }
    return p


def capacity(cfg, seq_len: int) -> int:
    e = cfg.moe
    c = int(math.ceil(seq_len * e.top_k / e.num_experts * e.capacity_factor))
    return max(e.top_k, min(c, seq_len * e.top_k))


def route(p, x, cfg):
    """Router in fp32. Returns (gates (b, s, k), experts (b, s, k), aux).

    ``torch.topk`` may order equal probabilities otherwise than
    ``lax.top_k``; fp32 router outputs of random inputs do not tie.
    """
    e = cfg.moe
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (b, s, E)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)             # (b, s, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    f = F.one_hot(idx, e.num_experts).float().sum(2).mean((0, 1))
    pbar = probs.mean((0, 1))
    aux = e.num_experts * (f * pbar).sum()
    return gates, idx, aux


def apply_moe(p, x, cfg):
    """x: (b, s, d) -> (y, aux_loss)."""
    if cfg.moe_constrained:
        raise NotImplementedError(
            "moe_constrained places the dispatch buffers on a device mesh "
            "(sharding.rules), which the port has not got (ROADMAP A11)")
    e = cfg.moe
    b, s, d = x.shape
    k, E = e.top_k, e.num_experts
    C = capacity(cfg, s)
    with record_function("moe_dispatch"):
        gates, idx, aux = route(p, x, cfg)

        # --- position of each (token, choice) in its expert's buffer ---
        onehot = F.one_hot(idx.reshape(b, s * k), E).transpose(1, 2).contiguous()
        seen = torch.cumsum(onehot, dim=2)                      # (b, E, s*k)
        slot = ((seen * onehot).sum(1) - 1).reshape(b, s, k)    # (b, s, k)
        rows = torch.arange(b, device=x.device)[:, None, None]
        # kept pairs land at (expert, row, slot); dropped ones at the drop row
        dest = torch.where(slot < C, (idx * b + rows) * C + slot, E * b * C)

        # --- dispatch: scatter tokens into (E, b, C, d) + the drop row ---
        x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
        buf = x.new_zeros((E * b * C + 1, d)).index_put(
            (dest.reshape(-1),), x_rep)
        buf = buf[:-1].view(E, b * C, d)                        # drop row off

    # --- expert computation: batched products over the buffer ---
    h = F.silu(cast_bmm(buf, p["wi"])) * cast_bmm(buf, p["wg"])
    out = cast_bmm(h, p["wo"])                                  # (E, b*C, d)

    # --- combine: gather back + weight by gates ---
    with record_function("moe_combine"):
        out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])  # drop row 0
        y = out.index_select(0, dest.reshape(-1)).view(b, s, k, d)
        y = (y * gates[..., None].to(x.dtype)).sum(2)           # (b, s, d)

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(cast_matmul(x, sp["wi"])) * cast_matmul(x, sp["wg"])
        y = y + cast_matmul(hs, sp["wo"])
    return y, aux * e.router_aux_weight
