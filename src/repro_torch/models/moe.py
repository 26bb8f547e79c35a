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

from repro_torch.models.layers import _winit, cast_bmm, cast_matmul, gather_dims
from repro_torch.obs.ranges import span
from repro_torch.sharding.rules import maybe_constrain, redistribute


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


def _route(router, x, cfg):
    """Router in fp32: (gates (b, s, k), experts (b, s, k), the fraction of
    choices routed to each expert (E,), the mean router probability of each
    expert (E,)), the means over x's rows."""
    e = cfg.moe
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                       # (b, s, E)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)             # (b, s, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    f = F.one_hot(idx, e.num_experts).float().sum(2).mean((0, 1))
    return gates, idx, f, probs.mean((0, 1))


def route(p, x, cfg):
    """Router in fp32. Returns (gates (b, s, k), experts (b, s, k), aux).

    ``torch.topk`` may order equal probabilities otherwise than
    ``lax.top_k``; fp32 router outputs of random inputs do not tie.
    """
    gates, idx, f, pbar = _route(p["router"], x, cfg)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    return gates, idx, cfg.moe.num_experts * (f * pbar).sum()


class _BatchRows:
    """The batch-local dispatch on a mesh: x a DTensor whose batch rows are
    sharded over some mesh dims (the data axes) and replicated over the
    others. The router, the slots, the scatter and the gather run on each
    rank's own rows (``local``), so that no reshape of the dispatch merges
    a sharded dim; ``wrap`` makes a local result a DTensor again, sharded
    over the same mesh dims at its batch dim, and ``mean`` a local mean over
    the rows the average of the ranks' (summed at once: the aux loss
    multiplies two such means)."""

    def __init__(self, x):
        from torch.distributed.tensor import Partial, Replicate, Shard
        self.mesh = x.device_mesh
        self.rows = [pl == Shard(0) for pl in x.placements]
        self.shard, self.replicate, self.partial = Shard, Replicate, Partial

    def local(self, t, *, replicated_param=False):
        if replicated_param:  # each data rank's grad is a partial sum
            t = t.redistribute(self.mesh, [self.replicate()] * len(self.rows))
            return t.to_local(grad_placements=[
                self.partial() if r else self.replicate() for r in self.rows])
        return t.to_local()

    def wrap(self, t, batch_dim):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(t, self.mesh, [
            self.shard(batch_dim) if r else self.replicate() for r in self.rows],
            run_check=False)

    def mean(self, t):
        from torch.distributed.tensor import DTensor
        k = 1
        for i, r in enumerate(self.rows):
            k *= self.mesh.size(i) if r else 1
        t = DTensor.from_local(t / k, self.mesh, [
            self.partial() if r else self.replicate() for r in self.rows],
            run_check=False)
        return t.redistribute(self.mesh, [self.replicate()] * len(self.rows))


def apply_moe(p, x, cfg):
    """x: (b, s, d) -> (y, aux_loss).

    On DTensors the router, the slots, the scatter and the gather run on
    each rank's own rows (``_BatchRows``), the expert products on DTensors,
    and the expert outputs are taken back to the rows' placements for the
    gather (both moves recorded in ``rules.REDISTRIBUTIONS``). The twin's
    partitioner places these steps itself; DTensor's sharding rules for the
    one-hot, the slot reshapes and the drop-row slice fail where a reshape
    merges a sharded dim. ``cfg.moe_constrained`` adds the twin's
    constraints: the scatter batch-local (E and C replicated within a data
    shard), then the dispatched buffer resharded to expert-parallel in one
    step; outside a mesh (``sharding.rules.set_mesh``) they do nothing.
    """
    e = cfg.moe
    k, E = e.top_k, e.num_experts
    C = capacity(cfg, x.shape[1])
    batch_only = lambda t: maybe_constrain(
        t, ("pod", "data"), *([None] * (t.ndim - 1)))
    rows = None
    with span("moe_dispatch"):
        router = p["router"]
        if cfg.moe_constrained:
            x = batch_only(x)  # x_rep, the scatter's source, is x's rows
        if _is_dtensor(x):
            # whole rows for the row-local dispatch: a batch the data axes
            # do not divide was relocated onto the sequence, and a feature
            # shard or a partial sum is gathered or summed
            x = gather_dims(x, (1, 2), tag="moe_rows")
            rows = _BatchRows(x)
            x_in = x
            x, router = rows.local(x), rows.local(router, replicated_param=True)
        b, s, d = x.shape
        gates, idx, f, pbar = _route(router, x, cfg)

        # --- position of each (token, choice) in its expert's buffer ---
        onehot = F.one_hot(idx.reshape(b, s * k), E).transpose(1, 2).contiguous()
        seen = torch.cumsum(onehot, dim=2)                      # (b, E, s*k)
        slot = ((seen * onehot).sum(1) - 1).reshape(b, s, k)    # (b, s, k)
        brow = torch.arange(b, device=x.device)[:, None, None]
        # kept pairs land at (expert, row, slot); dropped ones at the drop row
        dest = torch.where(slot < C, (idx * b + brow) * C + slot, E * b * C)

        # --- dispatch: scatter tokens into (E, b, C, d) + the drop row ---
        x_rep = x[:, :, None, :].expand(b, s, k, d).reshape(-1, d)
        buf = x.new_zeros((E * b * C + 1, d)).index_put(
            (dest.reshape(-1),), x_rep)
        buf = buf[:-1].view(E, b * C, d)                        # drop row off
        if rows is not None:
            buf = rows.wrap(buf, 1)
        if cfg.moe_constrained:
            buf = maybe_constrain(buf, None, ("pod", "data"), None)

    if cfg.moe_constrained:  # expert-parallel boundary: the all-to-all
        buf = maybe_constrain(buf, "model", ("pod", "data"), None)
    # --- expert computation: batched products over the buffer ---
    h = F.silu(cast_bmm(buf, p["wi"])) * cast_bmm(buf, p["wg"])
    out = cast_bmm(h, p["wo"])                                  # (E, b*C, d)
    if cfg.moe_constrained:
        out = maybe_constrain(out, "model", ("pod", "data"), None)

    # --- combine: gather back + weight by gates ---
    with span("moe_combine"):
        if rows is not None:  # every expert's rows of this rank's batch
            out = rows.local(redistribute(out, [
                rows.shard(1) if r else rows.replicate() for r in rows.rows],
                "moe_combine"))
        out = torch.cat([out.reshape(-1, d), out.new_zeros((1, d))])  # drop row 0
        y = out.index_select(0, dest.reshape(-1)).view(b, s, k, d)
        y = (y * gates[..., None].to(x.dtype)).sum(2)           # (b, s, d)
    if rows is not None:
        y, f, pbar, x = rows.wrap(y, 0), rows.mean(f), rows.mean(pbar), x_in
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    aux = E * (f * pbar).sum()

    if "shared" in p:
        sp = p["shared"]
        hs = F.silu(cast_matmul(x, sp["wi"])) * cast_matmul(x, sp["wg"])
        y = y + cast_matmul(hs, sp["wo"])
    return y, aux * e.router_aux_weight


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)
