"""Trace-calibrated simulator costs: fit Tf/Tb/eviction times from the
executor's per-instruction event trace and replay them through the
discrete-event simulator.

This closes the paper's §4 loop programmatically: instead of quoting
measured single-stage MFUs, run the real runtime (``PipelineExecutor``
with ``step(..., trace=True)``), fit per-op medians, and feed the
simulator/planner the observed numbers. The copy of the JAX package's
``planner/calibrate.py`` without its two measuring functions, which build an
executor: their torch versions, ``measure_stage_T`` and
``measure_stage_gain``, are in ``planner/measure.py``.

Traces export to Chrome trace format (chrome://tracing, Perfetto) and
round-trip back for offline fitting.
"""
from __future__ import annotations

import dataclasses
import re
import statistics
from typing import Dict, List, Optional

from repro_torch.core import plan
from repro_torch.core import schedule
from repro_torch.core import simulator as SIM
from repro_torch.core.notation import Notation
from repro_torch.core.schedule import B, EVICT, F, LOAD
from repro_torch.obs import export as _export
from repro_torch.planner.rank import AnalyticCostModel, CostModel


@dataclasses.dataclass(frozen=True)
class CalibratedCosts:
    """Per-device, per-microbatch times (seconds) fit from a trace.

    Tf/Tb are whole-device costs: interleaved traces time 1/v-sized chunk
    instructions, so the fit multiplies the chunk median back by v —
    matching ``SimConfig``'s convention (the simulator divides by v
    again). Sequence-sliced traces (``seq_chunks`` > 1) time 1/c-sized
    slice instructions the same way, so the fit multiplies by c too;
    EVICT/LOAD stay per-unit (a sliced unit IS the slice)."""
    Tf: float
    Tb: float
    t_evict: float = 0.0
    t_load: float = 0.0
    v: int = 1
    b: int = 0              # micro batch the trace ran at (0 = unknown)
    samples: int = 0
    seq_chunks: int = 1

    @property
    def t_move(self) -> float:
        """One balanced EVICT/LOAD transfer estimate."""
        pair = [t for t in (self.t_evict, self.t_load) if t > 0]
        return statistics.mean(pair) if pair else 0.0


_SLICE_RE = re.compile(r"\.s\d+")


def fit_trace(events, v: int = 1, b: int = 0,
              seq_chunks: int = 1) -> CalibratedCosts:
    """Fit simulator costs from an executor event stream — canonical
    ``repro_torch.obs.events.Span``s (``step(trace=True)`` or a reloaded
    trace; medians — robust to the odd scheduler hiccup; trace a warmed
    step, not the compile step). All slices of an op fold into one list
    and the F/B medians multiply back by ``seq_chunks`` (a slice is 1/c
    of the microbatch), mirroring the ``v`` convention. WAIT halves
    (``Span.phase``) and channel-occupancy spans are completion/queue
    bookkeeping, not instruction costs — they bin separately and stay
    out of the fit. Legacy string-suffixed ops (``F.s0``, ``LOAD+w``)
    from pre-obs traces still bin correctly."""
    by_op: Dict[str, List[float]] = {F: [], B: [], EVICT: [], LOAD: []}
    n = 0
    for e in events:
        n += 1
        if getattr(e, "track", "compute") == "channel":
            continue
        # residency ops (OFFLOAD/FETCH/DROP/RECOMPUTE, plugin policies)
        # are collected too — only F/B/EVICT/LOAD feed the fit
        op = _SLICE_RE.sub("", e.op)
        if getattr(e, "phase", "") == "wait" and not op.endswith("+w"):
            op += "+w"
        by_op.setdefault(op, []).append(e.duration)
    assert by_op[F] and by_op[B], "trace has no F/B instructions"
    med = {op: (statistics.median(ds) if ds else 0.0)
           for op, ds in by_op.items()}
    return CalibratedCosts(
        Tf=med[F] * v * seq_chunks, Tb=med[B] * v * seq_chunks,
        t_evict=med[EVICT], t_load=med[LOAD],
        v=v, b=b, samples=n, seq_chunks=seq_chunks)


def apply(costs: CalibratedCosts, cfg: SIM.SimConfig) -> SIM.SimConfig:
    """A SimConfig re-grounded in measured compute times. Eviction traffic
    keeps its analytic bytes/bandwidth model: on one host the store move
    is bookkeeping, so its measured duration says nothing about a real
    pair link."""
    return dataclasses.replace(cfg, Tf=costs.Tf, Tb=costs.Tb)


def replay(costs: CalibratedCosts, kind, p: Optional[int] = None,
           m: Optional[int] = None, v: int = 2,
           cap: Optional[int] = None, evict_bytes: float = 0.0,
           pair_bw: float = float("inf"), pair_hops: int = 1,
           t_p2p: float = 0.0) -> SIM.SimResult:
    """Simulate a schedule variant under the fitted costs. ``kind`` is a
    ``plan.ScheduleSpec`` (preferred) or a legacy kind name with the
    (p, m, v, cap) knobs."""
    if not isinstance(kind, plan.ScheduleSpec):
        kind = plan.ScheduleSpec(
            kind, p, m, v=v,
            cap=cap if kind in schedule.BPIPE_FAMILY else None)
    return SIM.simulate(SIM.SimConfig(
        spec=kind, Tf=costs.Tf, Tb=costs.Tb,
        evict_bytes=evict_bytes, pair_bw=pair_bw, pair_hops=pair_hops,
        t_p2p=t_p2p))


class TraceCostModel(CostModel):
    """CostModel anchored at one measured (b, T) point. Other micro batch
    sizes scale by the saturating-efficiency shape (T(b) proportional to
    b / eff(b), eff(b) = b/(b+k)) — a one-point version of
    ``estimator.fit_stage_mfu``'s curve.

    ``attention`` names the arm the trace ran under; other arms scale by
    the analytic time-factor ratios (a trace taken without recompute says
    nothing about recompute's re-forward cost, so the model must charge
    it rather than rank all arms at the traced time)."""

    def __init__(self, costs: CalibratedCosts, k: float = 0.25,
                 peak_per_chip: float = None, attention: str = "none"):
        assert costs.b > 0, "trace must record its micro batch size b"
        self.costs = costs
        self.k = k
        self._factors = AnalyticCostModel.TIME_FACTOR
        self.traced_attention = attention
        assert attention in self._factors, attention
        if peak_per_chip is not None:
            self.peak_per_chip = peak_per_chip

    def stage_T(self, n: Notation, attention: str) -> float:
        b0, b = self.costs.b, n.b
        T0 = self.costs.Tf + self.costs.Tb
        eff0 = b0 / (b0 + self.k)
        eff = b / (b + self.k)
        arm = (self._factors[attention]
               / self._factors[self.traced_attention])
        return T0 * (b / b0) * (eff0 / eff) * arm


# ---------------------------------------------------------------------------
# Chrome trace round trip — aliases into the unified exporter
# ---------------------------------------------------------------------------
# The ad-hoc serializer that used to live here (which dropped the
# WAIT-half ``+w`` and slice ``.sN`` distinctions on reload, mis-binning
# move medians on replayed calibrations) is replaced by ``repro_torch.obs.
# export``: structured args round-trip every span field losslessly, and
# the loader still parses old-format traces by suffix.
chrome_trace = _export.to_chrome
save_chrome_trace = _export.save_trace
load_chrome_trace = _export.load_trace

