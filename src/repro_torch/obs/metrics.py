"""Metrics registry: the derived quantities one span stream supports.

Everything here is a pure fold over the canonical event schema
(``obs.events``) — no engine callbacks, no second bookkeeping path. The
same functions summarize a simulated run (sim-time units) and a real
executor step (wall-clock seconds):

  * per-stage busy time, bubble fraction, WAIT-stall time and
    warmup/steady/drain phase splits (warmup ends at the stage's first
    backward; drain starts after its last forward — the 1F1B phase
    anatomy the paper's eq. 2/3 reason about),
  * per-channel occupancy: moves, busy (link-occupied) time, stall
    (data-ready-but-link-busy) time, utilization, and the in-flight
    peak recovered by sweeping the channel's span overlaps,
  * MFU from the makespan (``simulator.mfu_from_sim``'s formula, over
    observed spans),
  * a stepwise HBM-residency timeline: executor spans carry real store
    byte samples (``Span.hbm``); simulator spans are re-priced through
    the same byte weights ``memory_model``/``memory.store`` charge, so
    both engines produce comparable memory counter tracks for the
    Perfetto exporter.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.core.schedule import B, F
from repro_torch.memory import policy as respol
from repro_torch.obs import events as E
from repro_torch.obs.timeline import Timeline


@dataclasses.dataclass
class StageMetrics:
    """Per-stage anatomy of one step."""
    stage: int
    busy: float             # summed F/B (+RECOMPUTE re-forward) time
    stall: float            # summed WAIT-half time (completion barriers)
    warmup: float           # step start -> first B start
    steady: float           # first B start -> last F end
    drain: float            # last F end -> stage's last event end
    hbm_peak: float = 0.0   # peak resident bytes (0 if no byte source)

    @property
    def bubble_fraction(self) -> float:
        total = self.warmup + self.steady + self.drain
        return 1.0 - self.busy / total if total > 0 else 0.0


@dataclasses.dataclass
class ChannelMetrics:
    """Per-channel occupancy over one step."""
    key: Tuple
    moves: int
    busy: float             # summed transfer (link-occupancy) time
    stall: float            # summed data-ready-but-link-busy wait
    queue_peak: int         # max concurrently in-flight transfers

    def utilization(self, makespan: float) -> float:
        return self.busy / makespan if makespan > 0 else 0.0


@dataclasses.dataclass
class StepMetrics:
    """Everything the registry derives from one run's span stream."""
    makespan: float
    stages: List[StageMetrics]
    channels: List[ChannelMetrics]
    mfu: Optional[float] = None

    @property
    def bubble_fraction(self) -> float:
        total = self.makespan * len(self.stages)
        if total <= 0:
            return 0.0
        return 1.0 - sum(s.busy for s in self.stages) / total

    @property
    def stall(self) -> float:
        return sum(s.stall for s in self.stages)

    @property
    def hbm_peak(self) -> float:
        return max((s.hbm_peak for s in self.stages), default=0.0)

    @property
    def channel_busy(self) -> float:
        return sum(c.busy for c in self.channels)

    def channel_occupancy(self) -> float:
        """Max per-channel utilization — how close the busiest link is
        to being the bottleneck."""
        return max((c.utilization(self.makespan) for c in self.channels),
                   default=0.0)

    def to_dict(self) -> Dict:
        return {
            "makespan": self.makespan,
            "bubble_fraction": self.bubble_fraction,
            "stall": self.stall,
            "mfu": self.mfu,
            "hbm_peak": self.hbm_peak,
            "stages": [dataclasses.asdict(s) | {
                "bubble_fraction": s.bubble_fraction}
                for s in self.stages],
            "channels": [{
                "key": list(c.key), "moves": c.moves, "busy": c.busy,
                "stall": c.stall, "queue_peak": c.queue_peak,
                "utilization": c.utilization(self.makespan)}
                for c in self.channels],
        }


#: Ops whose span time is stage *compute* (busy): F, B, and every
#: recompute-mechanism restore (the re-forward bill).
def _busy_ops() -> frozenset:
    extra = {op for op, pol in respol.RESTORE_OPS.items()
             if pol.mechanism == "recompute"}
    return frozenset({F, B} | extra)


def _queue_peak(spans: List[E.Span]) -> int:
    """Max overlap among a channel's spans (sweep over endpoints)."""
    edges = []
    for s in spans:
        edges.append((s.start, 1))
        edges.append((s.end, -1))
    edges.sort(key=lambda e: (e[0], e[1]))
    cur = peak = 0
    for _, d in edges:
        cur += d
        peak = max(peak, cur)
    return peak


def compute(spans, p: Optional[int] = None,
            model_flops: Optional[float] = None, t: int = 1,
            peak_flops: Optional[float] = None,
            channel_stats: Optional[Mapping] = None) -> StepMetrics:
    """Fold a span stream into ``StepMetrics``.

    ``p`` widens the stage list beyond the stages that emitted spans
    (an idle stage is still a stage). ``model_flops``/``peak_flops``
    enable the MFU line. ``channel_stats`` (a ``SimResult.channels``
    mapping) refines channel stall/queue-peak with the engine's own
    accounting when available; otherwise both are recovered from the
    channel spans."""
    tl = spans if isinstance(spans, Timeline) else Timeline(spans)
    makespan = tl.makespan
    busy_ops = _busy_ops()
    n_stages = max(p or 0, tl.p)
    stages = []
    for i in range(n_stages):
        group = tl.stage(i)
        busy = sum(s.duration for s in group
                   if s.canonical and s.op in busy_ops)
        stall = sum(s.duration for s in group if s.is_wait)
        b_starts = [s.start for s in group if s.op == B and s.canonical]
        f_ends = [s.end for s in group if s.op == F and s.canonical]
        last = max((s.end for s in group), default=0.0)
        warmup = min(b_starts) if b_starts else last
        drain_from = max(f_ends) if f_ends else last
        hbm = max((s.hbm for s in group if s.hbm is not None),
                  default=0.0)
        stages.append(StageMetrics(
            stage=i, busy=busy, stall=stall, warmup=warmup,
            steady=max(0.0, drain_from - warmup),
            drain=max(0.0, last - drain_from), hbm_peak=hbm))
    channels = []
    for key in sorted(tl.by_channel):
        group = tl.channel(key)
        st = channel_stats.get(key) if channel_stats else None
        channels.append(ChannelMetrics(
            key=key, moves=len(group),
            busy=sum(s.duration for s in group),
            stall=getattr(st, "stall", 0.0),
            queue_peak=(getattr(st, "queue_peak", 0) if st
                        else _queue_peak(group))))
    mfu = None
    if model_flops and peak_flops and makespan > 0 and n_stages:
        mfu = model_flops / (makespan * n_stages * t * peak_flops)
    return StepMetrics(makespan=makespan, stages=stages,
                       channels=channels, mfu=mfu)


# ---------------------------------------------------------------------------
# HBM residency timeline
# ---------------------------------------------------------------------------
#: Per-stage byte weight of one stash unit: a flat float, or
#: ``(stage, chunk) -> bytes`` — the same contract
#: ``memory.store.ActivationStore`` weighs with.
UnitBytes = Union[float, Callable[[int, int], float]]


def hbm_timeline(spans, partner: Mapping[int, int],
                 unit_bytes: UnitBytes, retained_bytes: float = 0.0,
                 p: Optional[int] = None,
                 ) -> Dict[int, List[Tuple[float, float]]]:
    """Stepwise per-stage resident-byte series from a span stream.

    Executor spans carry measured store samples (``Span.hbm``) — those
    are used verbatim. Simulator spans carry no bytes, so the series is
    re-priced from the op semantics with the SAME byte weights the
    store and ``memory_model`` charge: F stashes one unit, B frees it,
    a swap release ships it to ``partner``, a host release moves it off
    the device, a recompute release keeps ``retained_bytes``; restores
    reverse their release. Returns ``{stage: [(t, bytes), ...]}`` in
    time order, one sample per byte-changing event."""
    tl = spans if isinstance(spans, Timeline) else Timeline(spans)
    w_fn = unit_bytes if callable(unit_bytes) \
        else (lambda stage, chunk, w=float(unit_bytes): w)
    n_stages = max(p or 0, tl.p)
    cur = {i: 0.0 for i in range(n_stages)}
    out: Dict[int, List[Tuple[float, float]]] = {
        i: [(0.0, 0.0)] for i in range(n_stages)}
    measured = any(s.hbm is not None for s in tl.spans)
    ordered = sorted((s for s in tl.spans if s.track == E.COMPUTE),
                     key=lambda s: (s.end, s.start))
    for s in ordered:
        i = s.stage
        if measured:
            if s.hbm is not None:
                out[i].append((s.end, s.hbm))
            continue
        if not s.canonical:
            continue
        w = w_fn(i, s.chunk)
        if s.op == F:
            cur[i] += w
        elif s.op == B:
            cur[i] -= w
        elif s.op in respol.RELEASE_OPS:
            pol = respol.RELEASE_OPS[s.op]
            cur[i] -= w
            if pol.swap:
                j = partner[i]
                cur[j] += w_fn(i, s.chunk)
                out[j].append((s.end, cur[j]))
            elif pol.mechanism == "recompute":
                cur[i] += retained_bytes
        elif s.op in respol.RESTORE_OPS:
            pol = respol.RESTORE_OPS[s.op]
            cur[i] += w
            if pol.swap:
                j = partner[i]
                cur[j] -= w_fn(i, s.chunk)
                out[j].append((s.end, cur[j]))
            elif pol.mechanism == "recompute":
                cur[i] -= retained_bytes
        else:
            continue
        out[i].append((s.end, cur[i]))
    return out


def hbm_peaks(timeline: Mapping[int, List[Tuple[float, float]]],
              ) -> Dict[int, float]:
    return {i: max((v for _, v in series), default=0.0)
            for i, series in timeline.items()}
