"""Memory feasibility pruning: does a candidate plan fit the HBM budget?

Consumes ``core.memory_model``'s per-stage peak accounting — stash-unit
counts from the actual schedule streams (cap-, v-chunk- and
residency-aware: units a policy spills off the device are charged only
their retained bytes) plus param/optimizer state — and ``core.bpipe``'s
pair layout for the per-pair hop cost the ranking stage charges eviction
traffic with (the device-ring-extent hop distances, not the p-sized
default).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.core import bpipe as BP
from repro_torch.core import memory_model as mm
from repro_torch.core import schedule as sched
from repro_torch.core.notation import Notation
from repro_torch.planner.space import Candidate

DEFAULT_WORKSPACE = 4 * 1024**3


@dataclasses.dataclass(frozen=True)
class Feasibility:
    ok: bool
    reason: str = ""            # "" when ok
    peak_bytes: float = 0.0     # max per-stage peak (act + params)
    pair_hops: int = 0          # max evictor<->acceptor ring hops

    @property
    def peak_gib(self) -> float:
        return self.peak_bytes / 2**30


def check(n: Notation, cand: Candidate, hbm_bytes: float,
          cfg: Optional[ModelConfig] = None,
          workspace: float = DEFAULT_WORKSPACE,
          stage_to_device: Optional[Tuple[int, ...]] = None) -> Feasibility:
    """Prune ``cand`` against the per-device HBM budget.

    ``stage_to_device`` overrides the pair-adjacent layout when the
    stages sit on a larger mesh axis; the resulting (corrected) hop
    distance feeds the ranking stage's eviction cost.
    """
    p = n.p
    if n.B % cand.b or cand.m != n.B // cand.b:
        return Feasibility(False, f"b={cand.b} does not tile B={n.B}")
    nb = n.replace(b=cand.b)
    if cand.kind in sched.INTERLEAVED:
        if cand.v < 2:
            return Feasibility(False, "interleaved needs v >= 2")
        if cand.m % p:
            return Feasibility(False, f"m={cand.m} % p={p} != 0")
    if cfg is not None and p * cand.v > cfg.num_layers:
        return Feasibility(False, f"p*v={p * cand.v} > {cfg.num_layers} layers")

    try:
        spec = cand.spec(p)
        # template=True: peak accounting saturates in m, so a large-m
        # candidate is priced off its small saturation template
        # (plan.peak_template_spec) — identical peaks, fraction of the
        # compile cost. Exception behavior (cap unbalanceable) is
        # m-independent past saturation too (property-pinned).
        peak = mm.max_stage_bytes(nb, cand.attention, spec, cfg,
                                  template=True)
    except (AssertionError, IndexError, ValueError):
        # _balance cannot hold the stream under this cap (too tight for
        # the in-flight transients at this (p, m, v)).
        return Feasibility(False, f"cap={cand.cap} unbalanceable")

    hops = 0
    if spec.balanced:
        plan = BP.plan(p, cand.m, stage_to_device, spec=spec)
        hops = max(BP.hop_distance(plan).values(), default=0)
    if peak + workspace > hbm_bytes:
        return Feasibility(
            False,
            f"OOM: {peak / 2**30:.1f} GiB + workspace > "
            f"{hbm_bytes / 2**30:.0f} GiB",
            peak_bytes=peak, pair_hops=hops)
    return Feasibility(True, peak_bytes=peak, pair_hops=hops)
