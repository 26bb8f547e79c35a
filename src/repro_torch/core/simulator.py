"""Discrete-event simulator of pipeline schedules (GPipe / 1F1B / BPipe,
plain and interleaved) — a handler set over ``plan.run``.

Validates the paper's closed-form estimates against explicit timelines and
quantifies what the paper *ignores* (its §4: "We also temporarily ignore
the overhead introduced by the BPipe technique"): eviction/load traffic
that fails to overlap shows up here as real makespan.

Model:
  * per-stage compute: Tf(b) forward, Tb(b) backward per microbatch; for
    interleaved kinds each of the v chunks does 1/v of the work, so a
    chunk's F costs Tf/v and its B costs Tb/v,
  * p2p boundary transfer between adjacent *virtual* stages: t_p2p
    (charged on every compiled dependency edge whose ``dep_hop`` is set —
    including the device p-1 -> device 0 wraparound between chunks),
  * residency moves (EVICT/LOAD, OFFLOAD/FETCH, plugin policies): priced
    by the transfer engine (``repro_torch.transfer``) on explicit per-device
    channels — the shared evictor<->acceptor pair link for the swap
    (bytes / pair_bw * hops), the direction-split D2H/H2D host link for
    offload (bytes / d2h_bw resp. h2d_bw). Each channel is a serialized
    FIFO, so overlap (or the lack of it) falls out of channel-queue
    occupancy rather than per-op special cases. A move's compiled ISSUE
    half starts the transfer as soon as its dependency is ready — a
    restore is issued up to ``spec.depth`` chunk-level F+B slots ahead
    of the backward it feeds (depth 1 = the classic one-slot prefetch,
    whose ``(Tf+Tb)/(2v)`` stall threshold is golden-pinned in
    tests/test_plan.py) — and the backward stalls only if the transfer
    is still in flight when it starts,
  * recompute-mechanism policies have no channel: DROP is free
    bookkeeping, and RECOMPUTE occupies the stage's compute frontier for
    one chunk-level forward (Tf/v) — the FLOPs bill of recomputation.

Pricing handlers are derived from the policy registry's mechanism field,
so a newly registered policy's ops are priced without edits here.

The schedule itself — streams, dependency edges, device hops, partner
map — comes precompiled from ``plan.compile_plan``; this module only
prices instructions. Makespans across plain/interleaved/BPipe/residency
variants are directly comparable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core import plan as P
from repro_torch.core.schedule import B, F
from repro_torch.memory import policy as respol
from repro_torch.transfer import TransferEngine
from repro_torch.transfer.channel import ChannelStats


@dataclasses.dataclass
class SimConfig:
    """Cost knobs plus the schedule variant to price.

    Preferred: ``SimConfig(spec=ScheduleSpec(...), Tf=..., Tb=...)``.
    Legacy: the (p, m, kind, v, cap) knobs construct the spec — kept as a
    deprecation shim; ``spec`` wins when both are given (it re-syncs the
    legacy fields so old readers of ``cfg.p``/``cfg.kind`` stay correct).
    """
    p: int = 0
    m: int = 0                  # microbatches
    Tf: float = 0.0             # forward time per microbatch per device
    Tb: float = 0.0             # backward time (typically 2*Tf)
    t_p2p: float = 0.0          # stage-boundary activation transfer
    evict_bytes: float = 0.0    # bytes per residency move (EVICT/OFFLOAD/..)
    pair_bw: float = float("inf")
    pair_hops: int = 1
    d2h_bw: float = float("inf")   # host link, device -> host (OFFLOAD)
    h2d_bw: float = float("inf")   # host link, host -> device (FETCH)
    t_vocab: float = 0.0        # vocab-parallel collective per boundary
                                # F/B (memory_model.vocab_collective_bytes
                                # / link bw; 0 at vocab_parallel=1)
    kind: str = "1f1b"
    v: int = 2                  # chunks per device (interleaved kinds only)
    cap: Optional[int] = None   # stash-cap override (balanced / residency)
    residency: str = "none"     # residency policy (plain kinds)
    depth: int = 1              # transfer-overlap depth (docs/transfer.md)
    spec: Optional[P.ScheduleSpec] = None

    def __post_init__(self):
        if self.spec is not None:
            self.p, self.m = self.spec.p, self.spec.m
            self.kind, self.cap = self.spec.kind, self.spec.cap
            self.residency = self.spec.residency
            self.depth = self.spec.depth
            if self.spec.interleaved:
                self.v = self.spec.v

    def to_spec(self) -> P.ScheduleSpec:
        """The schedule variant this config prices."""
        if self.spec is not None:
            return self.spec
        # residency goes into the constructor directly: building a
        # residency-less spec first would null a cap override (no active
        # policy -> no cap) before the replace could re-activate it
        return P.ScheduleSpec(self.kind, self.p, self.m, v=self.v,
                              cap=self.cap, residency=self.residency,
                              depth=self.depth)


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: List[float]           # per-stage compute-busy time
    load_stall: float           # total time backwards waited on restores
    timeline: Dict[int, List]   # (op, mb, chunk, sl, start, end) per stage
    move_time: float = 0.0      # summed residency-op time (link occupancy
                                # for swap/host moves, re-forward time for
                                # recompute) — the overhead exposure that
                                # breaks equal-makespan ties in the planner
    vocab_time: float = 0.0     # summed vocab-parallel collective time
                                # charged on boundary-stage F/B
    channels: Dict[tuple, ChannelStats] = dataclasses.field(
        default_factory=dict)   # per-channel occupancy (transfer engine)

    @property
    def bubble_fraction(self) -> float:
        total = self.makespan * len(self.busy)
        return 1.0 - sum(self.busy) / total

    @property
    def queue_peak(self) -> int:
        """Max in-flight transfers reached on any channel (0 when the
        schedule moves nothing) — bounded by ``spec.depth``."""
        return max((s.queue_peak for s in self.channels.values()),
                   default=0)


def _simulate(cfg: SimConfig, greedy: bool = True,
              observer=None) -> SimResult:
    spec = cfg.to_spec()
    schedule = P.compile_plan(spec)
    p, v = spec.p, spec.v
    # One full microbatch of F work per device is Tf regardless of v:
    # each chunk holds 1/v of the device's layers. Sequence slicing
    # divides the unit again — a slice is 1/seq_chunks of the tokens, so
    # sliced F/B cost Tf/(v*c), Tb/(v*c) on the compute frontier. (The
    # quadratic attention share of a slice actually shrinks sub-linearly;
    # the planner's cost model owns that refinement, the engine prices
    # the linear part.)
    c = spec.seq_chunks
    tf, tb = cfg.Tf / (v * c), cfg.Tb / (v * c)
    # Vocab-parallel collectives (spec.vocab_parallel > 1) ride the
    # boundary stages' compute frontier: every F and B of the first and
    # last *virtual* stage pays one all-reduce/gather of the (sliced)
    # boundary activation — cfg.t_vocab seconds, 1/c of it per slice.
    # The guard keeps the vp=1 hot path's arithmetic untouched.
    nv = p * v
    tvoc = cfg.t_vocab / c if cfg.t_vocab else 0.0
    t_move = (cfg.evict_bytes / cfg.pair_bw) * cfg.pair_hops \
        if cfg.evict_bytes else 0.0
    t_d2h = cfg.evict_bytes / cfg.d2h_bw if cfg.evict_bytes else 0.0
    t_h2d = cfg.evict_bytes / cfg.h2d_bw if cfg.evict_bytes else 0.0
    engine = TransferEngine(schedule, t_peer=t_move, t_d2h=t_d2h,
                            t_h2d=t_h2d, depth=spec.depth,
                            observer=observer)
    # Restores are issued up to ``depth`` chunk-level F+B slots ahead of
    # the backward they feed (issue-early): deeper overlap starts the
    # transfer earlier and rides the channel queue instead of the stage.
    window = spec.depth * (tf + tb)

    t_stage = {i: 0.0 for i in range(p)}    # stage compute frontier
    done: Dict[P.DepKey, float] = {}    # (op, stage, mb, chunk, sl) -> end
    busy = {i: 0.0 for i in range(p)}
    state = {"stall": 0.0, "last_b": 0.0, "move": 0.0, "vocab": 0.0}
    timeline: Dict[int, List] = {i: [] for i in range(p)}

    def finish(i, ins, start_t, end_t):
        timeline[i].append((ins.op, ins.mb, ins.chunk, ins.sl,
                            start_t, end_t))
        if observer is not None:
            # the observer sees the full schema (phase included); the
            # SimResult timeline keeps its pre-obs tuple shape untouched
            observer.emit(ins.op, i, ins.mb, ins.chunk, ins.sl, ins.phase,
                          start_t, end_t)

    def on_f(i, ins):
        if ins.dep is None:
            dep = 0.0
        else:
            dep = done.get(ins.dep)
            if dep is None:
                return P.BLOCKED
        hop = cfg.t_p2p if ins.dep_hop else 0.0
        start_t = max(t_stage[i], dep + hop)
        dt = tf
        if tvoc and (ins.vs == 0 or ins.vs == nv - 1):
            dt = tf + tvoc
            state["vocab"] += tvoc
        end_t = start_t + dt
        done[ins.done_key] = end_t
        busy[i] += dt
        t_stage[i] = end_t
        finish(i, ins, start_t, end_t)

    def on_b(i, ins):
        dep = done.get(ins.dep)
        if dep is None:
            return P.BLOCKED
        hop = cfg.t_p2p if ins.dep_hop else 0.0
        start_t = max(t_stage[i], dep + hop)
        for rop in _stall_ops:     # data-moving restores gate the backward
            le = done.get((rop, i, ins.mb, ins.chunk, ins.sl))
            if le is not None and le > start_t:
                state["stall"] += le - start_t
                start_t = le
        dt = tb
        if tvoc and (ins.vs == 0 or ins.vs == nv - 1):
            dt = tb + tvoc
            state["vocab"] += tvoc
        end_t = start_t + dt
        done[ins.done_key] = end_t
        state["last_b"] = max(state["last_b"], end_t)
        busy[i] += dt
        t_stage[i] = end_t
        finish(i, ins, start_t, end_t)

    def wait_span(i, ins):
        # WAIT halves are free in simulated time (completion is already
        # priced; the backward charges any residual stall), but they ARE
        # instructions — the observer sees a zero-duration barrier span
        # at the move's completion so sim and executor streams carry the
        # same instruction set. Never appended to the SimResult timeline.
        if observer is not None:
            t = done.get(ins.dep, 0.0)
            observer.emit(ins.op, i, ins.mb, ins.chunk, ins.sl, ins.phase,
                          t, t)

    def on_release(i, ins):
        # ISSUE: the copy starts when the unit's F finished and the
        # channel admits it; async — the stage frontier is untouched.
        # WAIT halves are free here: completion is already priced, and
        # the restore's dep edge consumes it.
        if ins.is_wait:
            return wait_span(i, ins)
        pol = respol.RELEASE_OPS[ins.op]
        ready = done[ins.dep]
        if pol.mechanism == "recompute":
            # freeing residuals is bookkeeping — no time, no link
            done[ins.done_key] = ready
            finish(i, ins, ready, ready)
            return None
        start_t, end_t = engine.issue(pol, i, ready, release=True, ins=ins)
        done[ins.done_key] = end_t
        state["move"] += end_t - start_t
        finish(i, ins, start_t, end_t)
        return None

    def on_restore(i, ins):
        # ISSUE: prefetched into the depth-sized window ahead of the
        # backward; the WAIT half is the completion barrier the backward
        # observes (charged there, as load-stall).
        if ins.is_wait:
            return wait_span(i, ins)
        pol = respol.RESTORE_OPS[ins.op]
        if pol.mechanism == "recompute":
            # re-run the chunk's forward ON the compute frontier: the
            # FLOPs bill of recomputation the paper's recompute arms pay
            start_t = max(t_stage[i], done[ins.dep])
            end_t = start_t + tf
            done[ins.done_key] = end_t
            state["move"] += tf
            busy[i] += tf
            t_stage[i] = end_t
            finish(i, ins, start_t, end_t)
            return None
        issue_t = max(0.0, t_stage[i] - window)
        ready = max(issue_t, done[ins.dep])
        start_t, end_t = engine.issue(pol, i, ready, release=False, ins=ins)
        done[ins.done_key] = end_t
        state["move"] += end_t - start_t
        finish(i, ins, start_t, end_t)
        return None

    # Pricing handlers by registered policy mechanism (via the transfer
    # engine): swap ops ride the pair link, host ops the per-device
    # direction-split host link, recompute ops the compute frontier. A
    # policy registered by a plugin is priced here with no simulator
    # edits.
    handlers = {F: on_f, B: on_b}
    for op in respol.RELEASE_OPS:
        handlers[op] = on_release
    for op in respol.RESTORE_OPS:
        handlers[op] = on_restore
    _stall_ops = tuple(op for op, pol in respol.RESTORE_OPS.items()
                       if pol.moves_data)

    P.run(schedule.streams, handlers, greedy=greedy, observer=observer,
          dep_gated=True)
    makespan = max(max(t_stage.values()), state["last_b"])
    return SimResult(makespan=makespan,
                     busy=[busy[i] for i in range(p)],
                     load_stall=state["stall"], timeline=timeline,
                     move_time=state["move"], vocab_time=state["vocab"],
                     channels=engine.stats())


# Public entry point. The dispatch loop itself lives in ``plan.run`` —
# this module contributes only the pricing handlers above. ``greedy``
# selects the engine order (True = dataflow drain, False = round-robin);
# for every channel with a single issuing stage the priced timeline is
# identical either way (the differential fuzz harness pins this).
simulate = _simulate


def mfu_from_sim(res: SimResult, model_flops: float, p: int, t: int,
                 peak_flops: float) -> float:
    """Observed-throughput MFU over the simulated step."""
    return model_flops / (res.makespan * p * t * peak_flops)


def ideal_makespan(cfg: SimConfig) -> float:
    """The paper's eq-2 idealization: (m + p - 1) * (Tf + Tb)."""
    return (cfg.m + cfg.p - 1) * (cfg.Tf + cfg.Tb)


def interleaved_ideal_makespan(cfg: SimConfig) -> float:
    """Megatron interleaved idealization: the pipeline ramp shrinks to
    (p - 1)/v flush units, so makespan ~= (m + (p - 1)/v)(Tf + Tb)."""
    return (cfg.m + (cfg.p - 1) / cfg.v) * (cfg.Tf + cfg.Tb)


def sliced_ideal_makespan(cfg: SimConfig) -> float:
    """Sequence-sliced idealization (SlimPipe direction): the fill/drain
    ramp is one slice per stage hop, so it shrinks c-fold and
    makespan ~= (m + (p - 1)/c)(Tf + Tb). At c=1 this is exactly the
    paper's eq-2 bound; for c > 1 slicing trades bubble for retained-KV
    memory — the quantity ``memory_model`` charges back."""
    c = cfg.to_spec().seq_chunks
    return (cfg.m + (cfg.p - 1) / c) * (cfg.Tf + cfg.Tb)
