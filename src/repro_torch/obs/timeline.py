"""Timeline: the ordered, per-track view over one run's span stream.

A ``Recorder`` collects spans in emission order; consumers (metrics,
export, compare) want them *organized* — per stage in time order, per
channel, with the run's extent resolved. ``Timeline`` is that view,
built once from any span iterable (a live ``Recorder``, a reloaded
Perfetto trace, a filtered subset) without copying payloads.

Simulated and real runs produce the same structure, which is the whole
point: ``obs.compare`` aligns two ``Timeline``s without caring which
engine produced which.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import events as E


class Timeline:
    """Spans of one run, indexed by track / stage / channel."""

    def __init__(self, spans: Iterable[E.Span]):
        self.spans: List[E.Span] = list(spans)
        self.by_stage: Dict[int, List[E.Span]] = {}
        self.by_channel: Dict[Tuple, List[E.Span]] = {}
        for j, s in enumerate(self.spans):
            if s.track == E.CHANNEL:
                self.by_channel.setdefault(s.channel, []).append(s)
            else:
                self.by_stage.setdefault(s.stage, []).append(s)
        for group in self.by_stage.values():
            group.sort(key=lambda s: (s.start, s.end))
        for group in self.by_channel.values():
            group.sort(key=lambda s: (s.start, s.end))

    # -- extent ----------------------------------------------------------
    @property
    def p(self) -> int:
        """Stage count (highest stage seen + 1)."""
        return max(self.by_stage, default=-1) + 1

    @property
    def makespan(self) -> float:
        return max((s.end for s in self.spans), default=0.0)

    @property
    def start(self) -> float:
        return min((s.start for s in self.spans), default=0.0)

    # -- selections ------------------------------------------------------
    def stage(self, i: int) -> List[E.Span]:
        return self.by_stage.get(i, [])

    def channel(self, key: Tuple) -> List[E.Span]:
        return self.by_channel.get(key, [])

    def canonical(self, stage: Optional[int] = None) -> List[E.Span]:
        """Canonical compute-track spans (WAIT barriers excluded) — one
        per instruction, what counts and medians bin over."""
        src = self.spans if stage is None else self.stage(stage)
        return [s for s in src if s.canonical]

    def ops(self) -> Dict[str, int]:
        """Canonical instruction census by op."""
        out: Dict[str, int] = {}
        for s in self.canonical():
            out[s.op] = out.get(s.op, 0) + 1
        return out

    def keys(self) -> set:
        """Compute-track span identities (WAIT halves included — they
        are instructions too; the differential invariant compares full
        sets)."""
        return {s.key for group in self.by_stage.values() for s in group}

    def order(self, stage: int) -> List[E.SpanKey]:
        """The stage's canonical keys in start order — the sequence
        ordering-divergence audits compare across engines."""
        return [s.key for s in self.stage(stage) if s.canonical]

    # -- derived scalars -------------------------------------------------
    def busy(self, stage: int, ops: Optional[Tuple[str, ...]] = None,
             ) -> float:
        """Summed canonical span time on a stage (optionally only the
        given ops)."""
        return sum(s.duration for s in self.canonical(stage)
                   if ops is None or s.op in ops)
