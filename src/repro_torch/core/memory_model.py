"""Analytical per-stage memory model for pipeline-parallel training.

Activation-per-layer formulas follow Korthikanti et al. ("Reducing
Activation Recomputation in Large Transformer Models"), which the paper
cites for its recompute arms. All sizes in bytes, bf16 activations,
sequence parallelism enabled (as the paper's runs: "enabled sequence
parallelism technique").

Attention arms (paper Table 3):
  none      - full activations:        s*b*h*(34 + 5*a*s/h) / t
  recompute - attention recomputed:    s*b*h*34 / t
  flash     - flash attention stores no s^2 intermediates: same 34sbh/t
              (plus the small log-sum-exp, ignored like the paper does)

Param/optimizer state: mixed-precision Adam = 18 bytes/param
(bf16 param+grad: 4, fp32 master+m+v: 12, +2 slack for fp32 grad accum
on the way into the optimizer — Megatron's distributed-optimizer-off
configuration, matching the paper's setup).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.core import plan as P
from repro_torch.core import schedule as sched
from repro_torch.core.notation import Notation

BYTES_PER_PARAM = 18.0

#: Schedule selector: a compiled-plan ``ScheduleSpec`` (preferred) or a
#: legacy kind name combined with the (v, cap) knob arguments.
KindOrSpec = Union[str, P.ScheduleSpec]


def _as_spec(kind: KindOrSpec, n: Notation, v: int = 1,
             cap: int = None) -> P.ScheduleSpec:
    """Normalize the legacy (kind, v, cap) knobs to a bound spec; a spec
    passed directly wins (its m is bound from the notation if unbound)."""
    if isinstance(kind, P.ScheduleSpec):
        assert kind.p == n.p, f"spec p={kind.p} != notation p={n.p}"
        return kind if kind.bound else kind.with_m(n.num_micro)
    return P.ScheduleSpec(kind, n.p, n.num_micro, v=max(v, 1), cap=cap)


def act_bytes_per_layer(n: Notation, attention: str) -> float:
    """Stashed activation bytes per layer per microbatch."""
    base = 34.0 * n.s * n.b * n.h / n.t
    if attention == "none":
        base += 5.0 * n.a * n.s * n.s * n.b / n.t
    elif attention in ("recompute", "flash"):
        pass
    else:
        raise ValueError(attention)
    return base


def act_bytes_per_stage(n: Notation, attention: str, v: int = 1) -> float:
    """One stash unit's bytes for one (virtual) stage: l/(p*v) layers +
    the boundary input activation (2sbh/t). v > 1 models interleaved
    schedules, whose units each hold 1/v of the device's layers — more
    units in flight, each proportionally smaller."""
    layers = n.l / (n.p * v)
    return layers * act_bytes_per_layer(n, attention) + 2.0 * n.s * n.b * n.h / n.t


def kv_bytes_per_slice(n: Notation, v: int = 1,
                       seq_chunks: int = 1) -> float:
    """Post-RoPE (k, v) bytes ONE sequence slice retains per (virtual)
    stage for later slices' causal attention: 4*(s/c)*b*h/t per layer
    (k + v, bf16, kv heads folded into h). This is the new dominant
    long-context term sequence slicing trades the 34sbh/t stash for."""
    layers = n.l / (n.p * v)
    return layers * 4.0 * n.s * n.b * n.h / (n.t * seq_chunks)


def sliced_unit_bytes(n: Notation, attention: str, v: int = 1,
                      seq_chunks: int = 1) -> float:
    """One stash unit's bytes under sequence slicing: 1/c of the stage
    stash plus the retained-KV prefix the slice's vjp holds, charged at
    the worst slice (c - 1 earlier slices — a uniform weight, so the
    compiled plan's unit counts stay the accounting currency). At
    seq_chunks=1 this is exactly ``act_bytes_per_stage``."""
    c = seq_chunks
    base = act_bytes_per_stage(n, attention, v) / c
    if c == 1:
        return base
    return base + (c - 1) * kv_bytes_per_slice(n, v, c)


#: bf16 param + grad bytes/param for a TIED embedding table's far-stage
#: replica: the fp32 master weight and Adam moments live with the
#: stage-0 owner (Megatron keeps one optimizer copy of a tied table and
#: all-reduces its grad), so the last stage pays only the working copy.
TIED_REPLICA_BYTES_PER_PARAM = 4.0


def vocab_param_count(n: Notation, cfg: ModelConfig = None) -> float:
    """Total embedding + LM-head parameters across their copies (ONE
    table when ``cfg.tie_embeddings``, two otherwise; the GPT-like
    fallback assumes untied like its historical ``2vh`` term). This is
    the share ``param_bytes_per_stage`` no longer spreads uniformly —
    ``vocab_bytes_per_stage`` charges it to the stages that hold it."""
    if cfg is not None:
        return float(cfg.vocab_size) * cfg.d_model \
            * (1 if cfg.tie_embeddings else 2)
    return 2.0 * n.v * n.h


def param_bytes_per_stage(n: Notation, cfg: ModelConfig = None) -> float:
    """Parameter + grad + optimizer bytes per device for one stage's
    transformer *blocks*. Embedding/LM-head state is NOT in here: it
    lives on the boundary stages (stage 0 / stage p-1), which the old
    uniform ``param_count()/p`` spread hid — ``vocab_bytes_per_stage``
    charges it where it sits."""
    if cfg is not None:
        params = (cfg.param_count() - vocab_param_count(n, cfg)) / n.p / n.t
    else:
        # GPT-like: 12 l h^2 block params, evenly striped over stages
        params = 12.0 * n.l * n.h**2 / (n.p * n.t)
    return params * BYTES_PER_PARAM


def logits_bytes(n: Notation) -> float:
    """The fp32 ``(b, s/t, v)`` logits tensor ``models/model.py``
    materializes for the cross-entropy (``loss_fn``'s
    ``logits.astype(float32)``) — a last-stage activation spike the
    34sbh/t stash accounting never sees. Charged as ONE live copy: the
    bf16 projection is transient and the softmax/logsumexp reductions
    happen in place along the vocab dim."""
    return 4.0 * n.b * n.s * n.v / n.t


def vocab_bytes_per_stage(n: Notation, cfg: ModelConfig = None,
                          vocab_parallel: int = 1) -> List[float]:
    """Per-stage embedding / LM-head / logits bytes — the first/last
    stage vocab spike, made visible (and splittable).

    Layout at ``vocab_parallel=1``: stage 0 holds the embedding table's
    full param+grad+optimizer state; stage p-1 holds the LM head's (a
    bf16 param+grad replica only when the table is tied — see
    ``TIED_REPLICA_BYTES_PER_PARAM``) plus the fp32 logits activation.
    ``p == 1`` stacks everything on the single stage (a tied table is
    one tensor, charged once).

    ``vocab_parallel=vp > 1`` (arxiv 2411.05288 direction) scatters the
    table's vocab rows over the FIRST vp stages and the head's rows +
    the logits shards over the LAST vp stages, 1/vp each; overlapping
    ranges simply add. The traffic this buys back is priced by
    ``vocab_collective_bytes`` / the simulator's boundary charge."""
    p = n.p
    tied = cfg.tie_embeddings if cfg is not None else False
    table = (float(cfg.vocab_size) * cfg.d_model if cfg is not None
             else float(n.v) * n.h) / n.t
    state = table * BYTES_PER_PARAM
    out = [0.0] * p
    if p == 1:
        out[0] = state + (0.0 if tied else state) + logits_bytes(n)
        return out
    vp = max(1, min(vocab_parallel, p))
    head_state = table * TIED_REPLICA_BYTES_PER_PARAM if tied else state
    for i in range(vp):
        out[i] += state / vp
    for i in range(p - vp, p):
        out[i] += (head_state + logits_bytes(n)) / vp
    return out


def vocab_collective_bytes(n: Notation, vocab_parallel: int = 1) -> float:
    """Link bytes ONE vocab-parallel collective moves per participating
    rank: a ring all-reduce/gather of the bf16 ``(b, s, h)`` boundary
    activation over vp ranks costs ``2(vp-1)/vp`` times the tensor
    (2sbh/t bytes). The embedding side pays one per microbatch forward
    (partial-lookup all-reduce), the head side one per forward (input
    gather) and one per backward (input-grad reduce-scatter); the
    simulator prices them symmetrically on boundary-stage F/B. 0 at
    ``vocab_parallel <= 1`` — no scatter, no collective."""
    vp = vocab_parallel
    if vp <= 1:
        return 0.0
    return 2.0 * (vp - 1) / vp * 2.0 * n.s * n.b * n.h / n.t


@dataclasses.dataclass
class StageMemory:
    stage: int
    peak_stash: int           # activations held at peak (incl. foreign)
    act_bytes: float
    param_bytes: float
    host_bytes: float = 0.0   # host-DRAM bytes at peak (host_offload)
    vocab_bytes: float = 0.0  # embedding/head state + fp32 logits share

    @property
    def total(self) -> float:
        return self.act_bytes + self.param_bytes + self.vocab_bytes


def per_stage_memory(n: Notation, attention: str, kind: KindOrSpec,
                     cfg: ModelConfig = None, v: int = 1,
                     cap: int = None, template: bool = False
                     ) -> List[StageMemory]:
    """Peak memory per pipeline stage under the given schedule variant
    (a ``ScheduleSpec``, or the legacy kind/v/cap knobs). Stash-unit
    counts come from the compiled plan's peak accounting; for interleaved
    kinds each unit is byte-weighted at 1/v of the device's layers.

    Residency policies change what a *released* unit costs: units
    spilled off the device store (``Schedule.peak_spilled``) are charged
    the policy's ``retained_bytes`` on the device (the boundary input
    for selective_recompute, nothing for host_offload — whose full unit
    bytes land in ``host_bytes`` instead).

    Transfer-overlap depth (``spec.depth``, docs/transfer.md) buys its
    overlap with memory: a data-moving policy at depth d may hold up to
    d in-flight restore transients per stage instead of the single one
    the cap already budgets, so stages that restore over a link are
    charged ``(d - 1)`` extra units.

    ``template=True`` compiles the spec's saturation template
    (``plan.peak_template_spec``) instead of the full stream when the
    kind's peak accounting is m-independent past the warmup ramp
    (``ScheduleKind.peak_saturates``) — identical peaks at a fraction of
    the compile cost; the planner's feasibility pass uses it. Byte
    weights are always the real spec's (they never read m)."""
    spec = _as_spec(kind, n, v, cap)
    sch = P.compile_plan(P.peak_template_spec(spec) if template else spec)
    peaks = sch.peak_stash
    spilled = sch.peak_spilled
    pol = spec.policy
    c = spec.seq_chunks
    per_mb = sliced_unit_bytes(n, attention, spec.v, c)
    retained = pol.retained_bytes(n, attention, spec.v)
    if c > 1:
        # a released slice retains 1/c of the policy's usual bytes
        # (recompute's boundary input shrinks with the slice) plus its
        # own KV — the recompute strip keeps (carry, kv) so later
        # slices' forwards can still read the prefix
        retained = retained / c
        if pol.mechanism == "recompute":
            retained += kv_bytes_per_slice(n, spec.v, c)
    pb = param_bytes_per_stage(n, cfg)
    vb = vocab_bytes_per_stage(n, cfg, spec.vocab_parallel)
    out = []
    for i in range(n.p):
        spill = spilled.get(i, 0)
        inflight = ((spec.depth - 1) if pol.moves_data
                    and sch.num_loads.get(i, 0) > 0 else 0)
        out.append(StageMemory(
            stage=i, peak_stash=peaks[i],
            act_bytes=(peaks[i] + inflight) * per_mb + spill * retained,
            param_bytes=pb,
            host_bytes=spill * per_mb if pol.mechanism == "host" else 0.0,
            vocab_bytes=vb[i]))
    return out


def max_stage_bytes(n: Notation, attention: str, kind: KindOrSpec,
                    cfg: ModelConfig = None, v: int = 1,
                    cap: int = None, template: bool = False) -> float:
    return max(s.total
               for s in per_stage_memory(n, attention, kind, cfg, v, cap,
                                         template=template))


def fits(n: Notation, attention: str, kind: KindOrSpec, device_bytes: float,
         cfg: ModelConfig = None, workspace: float = 4 * 1024**3,
         v: int = 1, cap: int = None) -> bool:
    """Does every stage fit in device memory (leaving CUDA/XLA workspace)?"""
    return (max_stage_bytes(n, attention, kind, cfg, v, cap)
            + workspace <= device_bytes)


def max_micro_batch(n: Notation, attention: str, kind: str,
                    device_bytes: float, cfg: ModelConfig = None,
                    v: int = 1) -> int:
    """Largest b (power of two, dividing B) that fits — the quantity BPipe
    unlocks (paper §4: 'we primarily use the reduced device memory to
    increase the micro batch size')."""
    best = 0
    b = 1
    while b <= n.B:
        if n.B % b == 0:
            cand = n.replace(b=b)
            # interleaved streams only exist for m % p == 0 — such a b is
            # ineligible, not an OOM
            if kind in sched.INTERLEAVED and cand.num_micro % cand.p != 0:
                b *= 2
                continue
            if fits(cand, attention, kind, device_bytes, cfg, v=v):
                best = b
        b *= 2
    return best


def eviction_bytes(n: Notation, attention: str, v: int = 1,
                   seq_chunks: int = 1) -> float:
    """Bytes moved per EVICT/LOAD (one stash unit: a microbatch's stage
    stash, 1/v of it for interleaved kinds, or a sequence slice plus its
    retained-KV prefix for sliced schedules)."""
    return sliced_unit_bytes(n, attention, v, seq_chunks)


def traffic_bytes(n: Notation, attention: str, spec: P.ScheduleSpec) -> float:
    """Total link bytes one step of ``spec`` moves.

    Residency part: the release+restore count of the stream actually
    built (``plan.num_moves`` — cap-, v- and residency-aware) times the
    per-unit stash bytes. Covers the partner swap (evictor<->acceptor)
    and host offload (D2H+H2D) alike; 0 when residency moves no data
    (none, or selective_recompute — whose bill is FLOPs, priced by the
    simulator's RECOMPUTE handler).

    Vocab-parallel part: four boundary collectives per microbatch (F+B
    on each of the two boundary stages — ``vocab_collective_bytes``);
    0 at ``vocab_parallel=1``."""
    spec = _as_spec(spec, n)
    total = 4.0 * spec.m * vocab_collective_bytes(n, spec.vocab_parallel)
    if spec.policy.moves_data:
        total += P.num_moves(spec) * eviction_bytes(n, attention, spec.v,
                                                    spec.seq_chunks)
    return total


def balance_report(n: Notation, attention: str) -> Dict[str, List[float]]:
    """1F1B vs BPipe per-stage activation bytes (the Fig.1 story)."""
    out = {}
    for kind in ("1f1b", "bpipe"):
        out[kind] = [s.act_bytes for s in per_stage_memory(n, attention, kind)]
    return out
