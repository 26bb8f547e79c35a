"""Sim-vs-real divergence audits: align the simulated timeline of a
``ScheduleSpec`` against the executor's trace of the SAME spec and
report where they disagree.

The paper's §4 method stands on the claim that the discrete-event model
predicts the real pipeline; this module makes that claim checkable per
run instead of per paper table. Both engines emit the same canonical
span schema (``obs.events``), so alignment is exact — spans match by
``Span.key`` — and divergence decomposes into:

  * **census**: instructions one stream has and the other lacks
    (``missing_in_real`` / ``missing_in_sim``; the differential-fuzz
    invariant pins these to empty for every valid spec),
  * **time skew**: per-op total-duration ratio, normalized by the
    overall makespan ratio (``time_scale``) so the units cancel — a
    skew of 1.0 means the op consumes the same *share* of its step in
    both engines; skew > 1 means the real op is relatively slower than
    the simulator prices it,
  * **ordering divergence**: per-stage normalized inversion distance
    (Kendall tau) between the two engines' canonical start orders — 0.0
    when the real dispatch replays the simulated order exactly, 1.0
    when it is fully reversed.

The copy of the JAX package's ``obs/compare.py`` without ``audit``, which
builds an executor: its torch version is ``planner/measure.audit``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.timeline import Timeline


@dataclasses.dataclass
class OpSkew:
    """Relative duration of one op class, real vs simulated."""
    op: str
    sim_total: float      # summed canonical sim durations (sim units)
    real_total: float     # summed canonical real durations (seconds)
    count: int            # canonical instructions of this op (both sides)
    skew: float           # (real share of real step) / (sim share of sim
    #                       step); 1.0 = the model prices the op's share
    #                       exactly


def _inversions(seq: List[int]) -> int:
    """Inversion count via merge sort (n log n — traces get long)."""
    if len(seq) < 2:
        return 0
    mid = len(seq) // 2
    left, right = seq[:mid], seq[mid:]
    inv = _inversions(left) + _inversions(right)
    merged, i, j = [], 0, 0
    while i < len(left) and j < len(right):
        if left[i] <= right[j]:
            merged.append(left[i])
            i += 1
        else:
            inv += len(left) - i
            merged.append(right[j])
            j += 1
    seq[:] = merged + left[i:] + right[j:]
    return inv


def order_divergence(sim_order: List, real_order: List) -> float:
    """Normalized Kendall distance between two key sequences over their
    common keys: 0.0 = same order, 1.0 = reversed."""
    pos = {k: idx for idx, k in enumerate(sim_order)}
    ranks = [pos[k] for k in real_order if k in pos]
    n = len(ranks)
    if n < 2:
        return 0.0
    return _inversions(ranks) / (n * (n - 1) / 2)


@dataclasses.dataclass
class CompareReport:
    """The alignment of one spec's simulated and real event streams."""
    label: str
    sim_count: int                      # canonical sim instructions
    real_count: int                     # canonical real instructions
    missing_in_real: List[Tuple]        # sim keys the real run never ran
    missing_in_sim: List[Tuple]         # real keys the model never priced
    time_scale: float                   # real makespan / sim makespan
    op_skew: List[OpSkew]
    order_div: Dict[int, float]         # stage -> normalized inversions

    @property
    def instruction_sets_match(self) -> bool:
        return not self.missing_in_real and not self.missing_in_sim

    @property
    def max_order_divergence(self) -> float:
        return max(self.order_div.values(), default=0.0)

    def format(self) -> str:
        lines = [f"# sim-vs-real audit: {self.label}",
                 f"instructions: sim={self.sim_count} real={self.real_count}"
                 f" missing_in_real={len(self.missing_in_real)}"
                 f" missing_in_sim={len(self.missing_in_sim)}",
                 f"time_scale (real/sim makespan): {self.time_scale:.4g}"]
        lines.append("op     n      sim_total  real_total  skew")
        for s in self.op_skew:
            lines.append(f"{s.op:<6} {s.count:<6d} {s.sim_total:<10.4g} "
                         f"{s.real_total:<11.4g} {s.skew:.3f}")
        div = " ".join(f"{i}:{d:.3f}" for i, d in sorted(
            self.order_div.items()))
        lines.append(f"order divergence per stage: {div}")
        return "\n".join(lines)

    def to_dict(self) -> Dict:
        return {
            "label": self.label, "sim_count": self.sim_count,
            "real_count": self.real_count,
            "missing_in_real": [list(k) for k in self.missing_in_real],
            "missing_in_sim": [list(k) for k in self.missing_in_sim],
            "time_scale": self.time_scale,
            "op_skew": [dataclasses.asdict(s) for s in self.op_skew],
            "order_divergence": {str(i): d
                                 for i, d in sorted(self.order_div.items())},
        }


def compare(sim_spans, real_spans, label: str = "") -> CompareReport:
    """Align two span streams of the same spec (any iterables of
    ``Span`` — live recorders, reloaded traces, timelines)."""
    sim = sim_spans if isinstance(sim_spans, Timeline) else Timeline(sim_spans)
    real = (real_spans if isinstance(real_spans, Timeline)
            else Timeline(real_spans))
    sim_keys, real_keys = sim.keys(), real.keys()
    scale = (real.makespan / sim.makespan
             if sim.makespan > 0 and real.makespan > 0 else 0.0)
    totals: Dict[str, List[float]] = {}
    for tl, slot in ((sim, 0), (real, 1)):
        for s in tl.canonical():
            totals.setdefault(s.op, [0.0, 0.0, 0])[slot] += s.duration
    counts, real_counts = sim.ops(), real.ops()
    skews = []
    for op in sorted(totals):
        st, rt, _ = totals[op]
        sim_share = st / sim.makespan if sim.makespan > 0 else 0.0
        real_share = rt / real.makespan if real.makespan > 0 else 0.0
        skews.append(OpSkew(
            op=op, sim_total=st, real_total=rt,
            count=counts.get(op, real_counts.get(op, 0)),
            skew=real_share / sim_share if sim_share > 0 else 0.0))
    div = {i: order_divergence(sim.order(i), real.order(i))
           for i in range(max(sim.p, real.p))}
    return CompareReport(
        label=label, sim_count=len(sim.canonical()),
        real_count=len(real.canonical()),
        missing_in_real=sorted(sim_keys - real_keys),
        missing_in_sim=sorted(real_keys - sim_keys),
        time_scale=scale, op_skew=skews, order_div=div)

