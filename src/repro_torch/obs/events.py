"""The ONE event schema and observer seam for everything ``plan.run``
dispatches (docs/observability.md).

The paper's §4 estimation method is only auditable if the simulator and
the real executor describe their work in the same vocabulary. This
module is that vocabulary — and, by the repo invariant enforced in
``scripts/check.sh``, the ONLY module that constructs trace spans:

  * ``Span`` — one timed event, keyed ``(op, stage, mb, chunk, sl,
    phase)``: exactly a compiled ``PlannedInstr``'s identity (including
    the ISSUE/WAIT halves of residency moves) plus ``start``/``end``
    in the emitter's clock (simulated time units for the simulator,
    wall-clock seconds for the executor). Channel occupancy rides the
    same schema on ``track="channel"`` with the transfer-channel key
    attached; real HBM residency rides along as the optional ``hbm``
    sample the executor reads off its ``ActivationStore``.
  * ``Observer`` — the contract the engines call: ``dispatch`` fires on
    every instruction the ready-loop retires (engine order — what
    ``obs.compare`` audits for ordering divergence), ``span`` receives
    every timed span, ``counter`` receives named counter samples.
    ``Observer.emit(...)`` is the single span-construction helper the
    simulator, executor, and transfer engine call — no other module
    builds a ``Span``.
  * ``Recorder`` — the collecting observer: spans + dispatch order +
    counters, with the small derived views (makespan, per-stage order)
    the metrics/timeline/export/compare layers build on.

Everything is zero-cost when no observer is attached: the engines guard
every emission with ``if observer is not None`` and otherwise run the
exact pre-instrumentation code path (golden-pinned).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

#: Move phases, shared with the compiled-plan IR (``plan.ISSUE`` /
#: ``plan.WAIT``): redeclared here (and asserted equal in tests) so the
#: event schema has no import edge back into the engine.
ISSUE, WAIT = "issue", "wait"

#: Span tracks: per-stage compute/move instructions vs. transfer-channel
#: occupancy intervals.
COMPUTE, CHANNEL = "compute", "channel"

#: The span identity tuple: (op, stage, mb, chunk, sl, phase).
SpanKey = Tuple[str, int, int, int, int, str]


@dataclasses.dataclass(frozen=True)
class Span:
    """One timed schedule event in the canonical schema.

    ``op``/``stage``/``mb``/``chunk``/``sl``/``phase`` are structured
    fields — the ``.sN`` / ``+w`` suffixes earlier trace paths folded
    into op strings (and lost on round trip) are presentation only
    (``label``). ``track`` separates stage instructions from channel
    occupancy; channel spans carry the transfer-channel ``channel`` key
    (``repro_torch.transfer.channel.channel_key`` vocabulary). ``hbm`` is the
    emitter's device-resident byte sample at ``end`` when it has one
    (the executor reads its store; the simulator leaves it None and
    ``obs.metrics.hbm_timeline`` reconstructs the counter from byte
    weights)."""
    op: str
    stage: int
    mb: int
    chunk: int = 0
    sl: int = 0
    phase: str = ""                       # "", ISSUE or WAIT
    start: float = 0.0
    end: float = 0.0
    track: str = COMPUTE
    channel: Optional[Tuple] = None       # channel key for channel spans
    hbm: Optional[float] = None           # stage-resident bytes at `end`

    @property
    def key(self) -> SpanKey:
        return (self.op, self.stage, self.mb, self.chunk, self.sl,
                self.phase)

    @property
    def duration(self) -> float:
        return self.end - self.start

    @property
    def is_wait(self) -> bool:
        return self.phase == WAIT

    @property
    def canonical(self) -> bool:
        """Does this span represent the event itself (not its completion
        barrier)? Canonical spans are what calibration medians and
        per-op counts bin over — one per instruction."""
        return self.phase != WAIT and self.track == COMPUTE

    @property
    def label(self) -> str:
        """Presentation label, matching ``PlannedInstr.__repr__``:
        ``EVICT3.c1.s2+w``. Purely derived — nothing parses it back."""
        c = f".c{self.chunk}" if self.chunk else ""
        s = f".s{self.sl}" if self.sl else ""
        w = "+w" if self.phase == WAIT else ""
        return f"{self.op}{self.mb}{c}{s}{w}"

    def to_args(self) -> Dict[str, Any]:
        """The lossless structured form the exporter writes (and
        ``from_args`` reads back bit-for-bit)."""
        out: Dict[str, Any] = {
            "op": self.op, "stage": self.stage, "mb": self.mb,
            "chunk": self.chunk, "sl": self.sl, "phase": self.phase,
            "track": self.track,
        }
        if self.channel is not None:
            out["channel"] = list(self.channel)
        if self.hbm is not None:
            out["hbm"] = self.hbm
        return out


def make(op: str, stage: int, mb: int, chunk: int = 0, sl: int = 0,
         phase: str = "", start: float = 0.0, end: float = 0.0,
         track: str = COMPUTE, channel: Optional[Sequence] = None,
         hbm: Optional[float] = None) -> Span:
    """The span factory every constructor path routes through (keeps
    ``Span(`` construction inside this module — the check.sh seam)."""
    return Span(op=op, stage=int(stage), mb=int(mb), chunk=int(chunk),
                sl=int(sl), phase=phase, start=float(start),
                end=float(end), track=track,
                channel=None if channel is None else tuple(channel),
                hbm=None if hbm is None else float(hbm))


def from_args(args: Mapping[str, Any], start: float, end: float) -> Span:
    """Rebuild a span from its exported structured args (the exporter's
    lossless round trip — ``obs.export.load_trace`` calls this)."""
    return make(args["op"], args["stage"], args["mb"],
                args.get("chunk", 0), args.get("sl", 0),
                args.get("phase", ""), start, end,
                args.get("track", COMPUTE), args.get("channel"),
                args.get("hbm"))


class Observer:
    """The observer contract the engines speak.

    Subclass and override what you need; the base class swallows
    everything (attach-and-ignore is valid). The engines only ever call
    these three callbacks plus ``emit``:

      dispatch(stage, ins)        engine-order: the ready-loop retired
                                  one ``PlannedInstr`` (simulator and
                                  executor alike — ``obs.compare`` diffs
                                  these orders)
      span(span)                  one timed ``Span``
      counter(name, stage, t, v)  a named counter sample
    """

    def dispatch(self, stage: int, ins: Any) -> None:  # noqa: ARG002
        pass

    def span(self, span: Span) -> None:  # noqa: ARG002
        pass

    def counter(self, name: str, stage: int, t: float,
                value: float) -> None:  # noqa: ARG002
        pass

    # -- emission helper (the only Span construction call site) --------
    def emit(self, op: str, stage: int, mb: int, chunk: int = 0,
             sl: int = 0, phase: str = "", start: float = 0.0,
             end: float = 0.0, track: str = COMPUTE,
             channel: Optional[Sequence] = None,
             hbm: Optional[float] = None) -> None:
        self.span(make(op, stage, mb, chunk, sl, phase, start, end,
                       track, channel, hbm))


@dataclasses.dataclass
class DispatchRecord:
    """One engine-order event: which instruction the loop retired."""
    stage: int
    key: SpanKey


class Recorder(Observer):
    """Collects the full event stream of one run."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.dispatches: List[DispatchRecord] = []
        self.counters: Dict[Tuple[str, int], List[Tuple[float, float]]] = {}

    # -- observer callbacks --------------------------------------------
    def dispatch(self, stage: int, ins: Any) -> None:
        self.dispatches.append(DispatchRecord(
            stage, (ins.op, stage, getattr(ins, "mb", -1),
                    getattr(ins, "chunk", 0), getattr(ins, "sl", 0),
                    getattr(ins, "phase", ""))))

    def span(self, span: Span) -> None:
        self.spans.append(span)

    def counter(self, name: str, stage: int, t: float,
                value: float) -> None:
        self.counters.setdefault((name, stage), []).append((t, value))

    # -- derived views --------------------------------------------------
    @property
    def makespan(self) -> float:
        return max((s.end for s in self.spans), default=0.0)

    def compute_spans(self) -> List[Span]:
        return [s for s in self.spans if s.track == COMPUTE]

    def channel_spans(self) -> List[Span]:
        return [s for s in self.spans if s.track == CHANNEL]

    def keys(self) -> set:
        """The instruction set this run executed (compute track) — the
        differential invariant: simulator and executor streams of the
        same spec must produce the SAME set."""
        return {s.key for s in self.spans if s.track == COMPUTE}

    def stage_order(self, stage: int) -> List[SpanKey]:
        """Keys of the stage's compute spans in start order (ties broken
        by emission order) — what ordering-divergence audits compare."""
        idx = [(s.start, j, s.key)
               for j, s in enumerate(self.spans)
               if s.track == COMPUTE and s.stage == stage]
        return [k for _, _, k in sorted(idx)]
