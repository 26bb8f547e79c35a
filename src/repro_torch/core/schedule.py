"""Pipeline schedules as per-stage instruction streams.

Core ops:
  F(mb)      forward of microbatch mb
  B(mb)      backward of microbatch mb

Residency ops (inserted by ``repro_torch.memory`` policies — docs/memory.md):
  EVICT(mb)      (bpipe_swap) ship mb's stashed activation to the partner
  LOAD(mb)       (bpipe_swap) fetch it back ahead of B(mb)
  OFFLOAD(mb)    (host_offload) copy the stash to host memory (D2H)
  FETCH(mb)      (host_offload) copy it back ahead of B(mb) (H2D)
  DROP(mb)       (selective_recompute) free the vjp residuals, keep the
                 boundary input
  RECOMPUTE(mb)  (selective_recompute) re-run the forward ahead of B(mb)

The streams are *data*. This module holds the stream builders and the
declarative kind registry (``SCHEDULES`` / ``register``); compiling a
stream set into a dispatchable artifact — dependency edges, partner map,
stash bounds, peak accounting — is ``core.plan``'s job, and every
consumer (simulator, executor, memory model, planner) runs off that
compiled ``plan.Schedule``. Registering a kind here is the ONE step that
makes it plannable, simulable, and executable (docs/api.md). Where a
stashed activation *lives* between its F and its B is the orthogonal
residency axis: ``repro_torch.memory.policy`` owns those rewrites and the
registry that extends the op set.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple

F, B, EVICT, LOAD = "F", "B", "EVICT", "LOAD"
OFFLOAD, FETCH = "OFFLOAD", "FETCH"
DROP, RECOMPUTE = "DROP", "RECOMPUTE"


@dataclasses.dataclass(frozen=True)
class Instr:
    op: str
    mb: int
    chunk: int = 0   # virtual-stage chunk (interleaved schedules only)
    sl: int = 0      # sequence slice (seq_chunks > 1 schedules only)

    def __repr__(self):
        c = f".c{self.chunk}" if self.chunk else ""
        s = f".s{self.sl}" if self.sl else ""
        return f"{self.op}{self.mb}{c}{s}"


Stream = List[Instr]


# Base F/B streams are pure functions of small integer tuples, rebuilt
# for every cap/residency/depth ladder neighbor the planner compiles —
# the cached tuple variants (suffix ``_t``) make that rebuild a lookup.
# The public builders return fresh lists (the historical mutable API);
# in-module consumers (the balanced builders' spill rewrites) read the
# tuples directly and never mutate them.
@functools.lru_cache(maxsize=1024)
def _gpipe_t(p: int, m: int, stage: int,
             seq_chunks: int = 1) -> Tuple[Instr, ...]:
    c = seq_chunks
    return tuple([Instr(F, j, 0, s) for j in range(m) for s in range(c)]
                 + [Instr(B, j, 0, c - 1 - s) for j in range(m)
                    for s in range(c)])


def gpipe(p: int, m: int, stage: int, seq_chunks: int = 1) -> Stream:
    """All forwards, then all backwards. Peak stash = m (m * seq_chunks
    sliced units when the sequence is sliced).

    Sliced forwards run slices in causal order (slice i's attention reads
    the retained KV of slices < i); backwards run slices in REVERSE order
    within each microbatch so the executor can accumulate the prefix-KV
    cotangents in one pass (docs/longcontext.md)."""
    return list(_gpipe_t(p, m, stage, seq_chunks))


@functools.lru_cache(maxsize=1024)
def _one_f_one_b_t(p: int, m: int, stage: int,
                   seq_chunks: int = 1) -> Tuple[Instr, ...]:
    c = seq_chunks
    total = m * c
    warmup = min(p - stage - 1 + (c - 1), total)

    def fwd(k):
        return k // c, k % c              # (mb, sl): causal slice order

    def bwd(k):
        return k // c, c - 1 - k % c      # reverse slice order within mb

    out: Stream = []
    nf = nb = 0
    for _ in range(warmup):
        mb, sl = fwd(nf)
        out.append(Instr(F, mb, 0, sl)); nf += 1
    while nf < total:
        mb, sl = fwd(nf)
        out.append(Instr(F, mb, 0, sl)); nf += 1
        mb, sl = bwd(nb)
        out.append(Instr(B, mb, 0, sl)); nb += 1
    while nb < total:
        mb, sl = bwd(nb)
        out.append(Instr(B, mb, 0, sl)); nb += 1
    return tuple(out)


def one_f_one_b(p: int, m: int, stage: int, seq_chunks: int = 1) -> Stream:
    """Non-interleaved 1F1B (DAPPLE / Megatron default).

    Stage i runs min(p-i-1, m) warmup forwards, then alternates F/B, then
    drains. Peak in-flight stash = min(p - i, m)  — the paper's "stage x
    stores p - x activations" imbalance.

    ``seq_chunks=c`` slices every microbatch into c sequence slices
    (SlimPipe direction): the pipeline unit becomes one slice, forwards
    visit slices in causal order, backwards in reverse order within each
    microbatch, and warmup grows by c - 1 (the extra ramp that keeps the
    last stage's B0 fed). At c=1 this is byte-for-byte the classic
    stream."""
    return list(_one_f_one_b_t(p, m, stage, seq_chunks))


def bpipe_cap(p: int) -> int:
    """BPipe's per-device activation bound: ceil((p+2)/2)."""
    return (p + 2 + 1) // 2


def bpipe_pairs(p: int) -> List[Tuple[int, int]]:
    """(evictor, acceptor) pairs: stage x < floor(p/2) pairs with p-1-x."""
    return [(x, p - 1 - x) for x in range(p // 2)]


def _balance(base: Stream, cap: int) -> Stream:
    """BPipe's continuous balancing over any F/B stream (re-homed to
    ``repro_torch.memory.policy.spill`` — the cap-driven rewrite is shared by
    every residency policy; this wrapper pins the EVICT/LOAD op pair the
    balanced schedule kinds emit)."""
    from repro_torch.memory.policy import spill
    return spill(base, cap, EVICT, LOAD)


def bpipe(p: int, m: int, stage: int, cap: int | None = None,
          seq_chunks: int = 1) -> Stream:
    """BPipe = 1F1B + continuous activation balancing at cap
    ceil((p+2)/2) (Kim et al.). Stages with steady in-flight
    p-stage <= cap never evict (acceptors / middle stages). In steady
    state every forward evicts and every backward reloads — the traffic
    is continuous, which is why overlap (NVLink / 1-hop ICI) is
    load-bearing for BPipe's viability; the simulator charges it.

    ``cap`` overrides the paper's default bound: the planner searches
    over it (looser cap -> fewer evictions but more evictor memory;
    tighter -> the reverse, pushed onto the acceptor). Must be >= 2
    (one live forward plus the in-flight LOAD transient).

    With ``seq_chunks=c``, cap counts sliced units and the default bound
    grows by the extra c - 1 warmup slices (each 1/c the bytes, so the
    byte budget still shrinks — see ``memory_model``).
    """
    cap = bpipe_cap(p) + (seq_chunks - 1) if cap is None else cap
    assert cap >= 2, cap
    return _balance(_one_f_one_b_t(p, m, stage, seq_chunks), cap)


# ---------------------------------------------------------------------------
# Interleaved (virtual-chunk) 1F1B — beyond-paper extension
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=1024)
def _one_f_one_b_interleaved_t(p: int, m: int, stage: int,
                               v: int = 2) -> Tuple[Instr, ...]:
    assert v >= 2 and m % p == 0, (v, m, p)
    total = m * v

    def fwd_unit(k):
        group, rem = divmod(k, p * v)
        return rem // p, group * p + rem % p       # (chunk, mb)

    def bwd_unit(k):
        group, rem = divmod(k, p * v)
        return v - 1 - rem // p, group * p + rem % p

    warmup = min((p - stage - 1) * 2 + (v - 1) * p, total)
    out: Stream = []
    nf = nb = 0
    for _ in range(warmup):
        c, mb = fwd_unit(nf)
        out.append(Instr(F, mb, c))
        nf += 1
    while nf < total:
        c, mb = fwd_unit(nf)
        out.append(Instr(F, mb, c))
        nf += 1
        c, mb = bwd_unit(nb)
        out.append(Instr(B, mb, c))
        nb += 1
    while nb < total:
        c, mb = bwd_unit(nb)
        out.append(Instr(B, mb, c))
        nb += 1
    return tuple(out)


def one_f_one_b_interleaved(p: int, m: int, stage: int, v: int = 2) -> Stream:
    """Megatron interleaved 1F1B: device ``stage`` hosts v model chunks
    (virtual stages stage + c*p). Bubble shrinks ~v-fold; warmup stash
    grows to 2(p-stage-1) + (v-1)p + 1 units (each 1/v the layers).
    Requires m % p == 0 and v >= 2."""
    return list(_one_f_one_b_interleaved_t(p, m, stage, v))


def interleaved_peak(p: int, m: int, stage: int, v: int = 2) -> int:
    """In-flight stash units at peak under interleaved 1F1B."""
    return min((p - stage - 1) * 2 + (v - 1) * p, m * v) + 1


def bpipe_interleaved_cap(p: int, v: int = 2) -> int:
    """BPipe bound generalized to v chunks: the pair-summed peak
    2(p-1) + 2(v-1)p + 2 is stage-independent (the same symmetry the
    paper's pairing exploits), so the balanced per-device bound is half
    of it plus the LOAD transient slot."""
    pair_sum = 2 * (p - 1) + 2 * (v - 1) * p + 2
    return (pair_sum + 1) // 2 + 1


def bpipe_interleaved(p: int, m: int, stage: int, v: int = 2,
                      cap: int | None = None) -> Stream:
    """BPipe x interleaved-1F1B composition (not in either paper): the
    same evict-newest/load-before-backward balancing applied to
    (chunk, mb) units, bounded by ``bpipe_interleaved_cap`` (or a
    planner-chosen ``cap`` override, >= 2)."""
    cap = bpipe_interleaved_cap(p, v) if cap is None else cap
    assert cap >= 2, cap
    return _balance(_one_f_one_b_interleaved_t(p, m, stage, v), cap)


# ---------------------------------------------------------------------------
# The kind registry — one declarative entry per schedule kind
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleKind:
    """Everything the rest of the system needs to know about a schedule
    kind. Registering one of these (``register``) makes the kind
    compilable (``plan.compile_plan``), plannable (``planner.space``),
    simulable, and executable — no interpreter edits.

    Fields:
      name:        registry key (``ScheduleSpec.kind``).
      builder:     per-stage stream builder. Signature by flags:
                   ``(p, m, stage)`` plain, ``+ v`` if interleaved,
                   ``+ cap=None`` keyword if balanced.
      interleaved: streams carry virtual-chunk instructions (v >= 2,
                   m % p == 0, p*v <= num_layers).
      balanced:    BPipe family — emits EVICT/LOAD under a stash cap and
                   accepts a ``cap`` override.
      sliced:      the builder accepts a ``seq_chunks`` keyword and emits
                   per-sequence-slice units (docs/longcontext.md).
                   ``ScheduleSpec`` normalizes seq_chunks to 1 for kinds
                   without it. Interleaved kinds cannot slice: the
                   sliced warmup ramp deadlocks against the chunk-major
                   unit order.
      default_cap: ``(p, v) -> int`` — the kind's default stash bound
                   (balanced kinds only). Sliced caps count slice units;
                   the builder/spec add the (seq_chunks - 1) warmup
                   allowance so this signature stays (p, v).
      cap_roof:    ``(p, m, v) -> int`` — the cap above which balancing
                   degenerates to the unbalanced twin; bounds the
                   planner's cap search (balanced kinds only).
      peak_saturates: per-stage peak stash/spill accounting is
                   m-independent once m passes the warmup ramp
                   (``plan.PEAK_SATURATION_FACTOR * p * seq_chunks``) —
                   true for the 1F1B cadence family, false for
                   all-forwards-first shapes like gpipe (peak = m).
                   Opting in lets feasibility-style consumers bind a
                   large-m spec to a small saturation template
                   (``plan.peak_template_spec``) instead of compiling
                   the full stream. Leave False for a new kind unless
                   the property holds (tests/test_planner_bnb.py pins
                   it for the built-ins).
    """
    name: str
    builder: Callable[..., Stream]
    interleaved: bool = False
    balanced: bool = False
    sliced: bool = False
    default_cap: Optional[Callable[[int, int], int]] = None
    cap_roof: Optional[Callable[[int, int, int], int]] = None
    peak_saturates: bool = False

    def __post_init__(self):
        if self.balanced and (self.default_cap is None
                              or self.cap_roof is None):
            raise ValueError(
                f"{self.name}: balanced kinds need default_cap and "
                f"cap_roof — the planner's cap search depends on both")

    def stream(self, p: int, m: int, stage: int, v: int = 1,
               cap: Optional[int] = None, seq_chunks: int = 1) -> Stream:
        """Build stage ``stage``'s raw instruction stream (the normalized
        entry point ``plan.compile_plan`` calls)."""
        kw = {}
        if self.balanced and cap is not None:
            kw["cap"] = cap
        if self.sliced and seq_chunks != 1:
            kw["seq_chunks"] = seq_chunks
        if self.interleaved:
            return self.builder(p, m, stage, v, **kw)
        return self.builder(p, m, stage, **kw)


SCHEDULES: Dict[str, ScheduleKind] = {}

# Kinds whose streams carry virtual-chunk instructions / balance a stash
# cap — derived from the registry, rebuilt on every ``register`` call.
INTERLEAVED: frozenset = frozenset()
BPIPE_FAMILY: frozenset = frozenset()


def _rebuild_derived() -> None:
    global INTERLEAVED, BPIPE_FAMILY
    INTERLEAVED = frozenset(k for k, e in SCHEDULES.items() if e.interleaved)
    BPIPE_FAMILY = frozenset(k for k, e in SCHEDULES.items() if e.balanced)


def register(entry: ScheduleKind, replace: bool = False) -> ScheduleKind:
    """Register a schedule kind. ``replace=False`` guards against
    accidental shadowing. Clears the plan-compile cache so a replaced
    kind cannot serve stale artifacts."""
    if entry.name in SCHEDULES and not replace:
        raise ValueError(f"schedule kind {entry.name!r} already registered")
    SCHEDULES[entry.name] = entry
    _rebuild_derived()
    from repro_torch.core import plan as _plan   # deferred: plan imports us
    _plan.compile_plan.cache_clear()
    return entry


def unregister(name: str) -> None:
    """Remove a registered kind (tests / plugin teardown)."""
    SCHEDULES.pop(name, None)
    _rebuild_derived()
    from repro_torch.core import plan as _plan
    _plan.compile_plan.cache_clear()


for _entry in (
    ScheduleKind("gpipe", gpipe, sliced=True),
    ScheduleKind("1f1b", one_f_one_b, sliced=True, peak_saturates=True),
    ScheduleKind("bpipe", bpipe, balanced=True, sliced=True,
                 peak_saturates=True,
                 default_cap=lambda p, v: bpipe_cap(p),
                 cap_roof=lambda p, m, v: max(min(p, m), 2)),
    ScheduleKind("1f1b_interleaved", one_f_one_b_interleaved,
                 interleaved=True, peak_saturates=True),
    ScheduleKind("bpipe_interleaved", bpipe_interleaved, interleaved=True,
                 balanced=True, peak_saturates=True,
                 default_cap=bpipe_interleaved_cap,
                 cap_roof=lambda p, m, v: max(interleaved_peak(p, m, 0, v),
                                              2)),
):
    SCHEDULES[_entry.name] = _entry
_rebuild_derived()
del _entry


def virtual_stage(stage: int, chunk: int, p: int) -> int:
    """Model-order index of device ``stage``'s chunk ``chunk``: chunk c on
    device s hosts the layer slice of virtual stage c*p + s."""
    return chunk * p + stage


def schedule_cap(kind: str, p: int, v: int = 2,
                 cap: int | None = None,
                 seq_chunks: int = 1) -> int | None:
    """The schedule's per-device stash bound (or the ``cap`` override for
    balanced kinds), or None if unbounded. Sliced schedules
    (seq_chunks > 1) count slice units and widen the default bound by the
    extra warmup slices."""
    entry = SCHEDULES[kind]
    if not entry.balanced:
        return None
    if cap is not None:
        return cap
    base = entry.default_cap(p, v if entry.interleaved else 1)
    if entry.sliced and seq_chunks > 1:
        base += seq_chunks - 1
    return base


# ---------------------------------------------------------------------------
# Legacy knob-tuple entry points — thin shims over ``core.plan``.
# New code should construct a ``plan.ScheduleSpec`` and compile it.
# ---------------------------------------------------------------------------
def _spec(kind: str, p: int, m: int, v: int = 2, cap: int | None = None):
    from repro_torch.core import plan as _plan
    entry = SCHEDULES[kind]
    return _plan.ScheduleSpec(kind, p, m,
                              v=v if entry.interleaved else 1,
                              cap=cap if entry.balanced else None)


def build(kind: str, p: int, m: int, v: int = 2,
          cap: int | None = None) -> Dict[int, Stream]:
    """Per-stage raw instruction streams (legacy view of the compiled
    plan; ``plan.compile_plan(spec).streams`` carries the dep-resolved
    version)."""
    from repro_torch.core import plan as _plan
    return _plan.compile_plan(_spec(kind, p, m, v, cap)).instr_streams()


def stash_trace(streams: Dict[int, Stream], p: int) -> Dict[int, List[int]]:
    """Per-stage trace of LOCAL stashed-activation counts after each event,
    including foreign stashes accepted from the paired evictor (a
    round-robin merge is enough for counting because EVICT/LOAD only move
    stash between fixed pairs)."""
    from repro_torch.core import plan as _plan
    return _plan.stash_accounting(streams, p)[0]


def peak_stash(kind: str, p: int, m: int, v: int = 2,
               cap: int | None = None) -> Dict[int, int]:
    """Peak per-stage stash count (local + accepted foreign). Units are
    (mb, chunk) — for interleaved kinds each unit holds 1/v of the layers,
    so byte-weighting is the memory model's job (see
    ``memory_model.act_bytes_per_stage``). A non-default BPipe ``cap``
    shifts stash between evictors and acceptors; this accounting is what
    the planner's feasibility check consumes."""
    from repro_torch.core import plan as _plan
    return dict(_plan.compile_plan(_spec(kind, p, m, v, cap)).peak_stash)


def num_evictions(p: int, m: int, stage: int, kind: str = "bpipe",
                  v: int = 2, cap: int | None = None) -> int:
    """How many EVICTs ``stage`` performs over a step. Generalized to any
    balanced kind and cap override (``plan.num_moves`` gives the total
    EVICT+LOAD traffic count for a spec)."""
    from repro_torch.core import plan as _plan
    return _plan.compile_plan(_spec(kind, p, m, v, cap)).num_evictions[stage]
