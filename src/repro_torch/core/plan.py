"""Compiled schedule plans: the one place a pipeline schedule is turned
from a name-plus-knobs into an executable artifact.

The paper's whole argument is a comparison across schedule variants, so a
variant must be a *value*, not a loose ``(kind, p, m, v, cap)`` tuple
re-threaded through every module. Following the plan-as-artifact designs
of Alpa (compile the parallel plan once, hand it to every consumer) and
Megatron-LM's schedule registry:

  * ``ScheduleSpec`` — the typed, validated, hashable identity of a
    schedule variant. Everything downstream (simulator, executor, memory
    model, planner, benchmarks) speaks specs.
  * ``compile_plan(spec) -> Schedule`` — compiled ONCE (lru-cached on the
    spec): per-stage instruction streams with each instruction's resolved
    upstream dependency edge and device hop, the evictor/acceptor partner
    map, per-stage stash bounds, eviction/load counts, and peak-stash
    accounting. Every residency move is split into ISSUE/WAIT halves —
    the issue-early/complete-lazy transfer contract (docs/transfer.md)
    the simulator prices on channels and the executor maps onto real
    async copies. Consumers stop re-deriving any of this per call.
  * ``run(streams, handlers)`` — the single generic ready-instruction
    dispatch loop (with deadlock detection). The discrete-event simulator,
    the executable runtime, and the stash accounting are all handler sets
    over this engine; none of them owns a scheduling loop anymore.

Adding a schedule kind is one declarative ``schedule.register(...)`` call
(stream builder + flags + cap formulas); it is then compilable, plannable,
simulable, and executable with no interpreter edits. See docs/api.md.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from repro_torch.core import schedule as sched
from repro_torch.core.schedule import B, EVICT, F, LOAD, Instr
# Importing the policy module via the package registers the built-in
# residency policies (none / bpipe_swap / host_offload /
# selective_recompute) before any spec validates against them.
from repro_torch.memory import policy as respol

# Dependency edge: completion of (op, stage, mb, chunk, sl) upstream.
DepKey = Tuple[str, int, int, int, int]


# ---------------------------------------------------------------------------
# ScheduleSpec — the schedule variant as a value
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Identity of one pipeline-schedule variant.

    Fields:
      kind: registered schedule kind (``schedule.SCHEDULES``).
      p:    pipeline stages (devices).
      m:    microbatches per step. ``m=0`` leaves the spec *unbound* — a
            template the executor binds to the real batch at ``step()``
            (``with_m``); compiling requires a bound spec.
      v:    virtual chunks per device; normalized to 1 for plain kinds.
      cap:  local-stash bound override for balanced (BPipe-family) kinds
            and for active residency policies on plain kinds; normalized
            to None when it equals the default bound (and when nothing
            caps the stash), so two spellings of the same variant hash
            and compare equal.
      residency: where a stashed activation lives between its F and its
            B (``repro_torch.memory.policy.POLICIES``). Balanced kinds embed
            the partner swap, so their residency normalizes to
            ``"bpipe_swap"``; unbalanced kinds accept ``"none"``,
            ``"host_offload"``, ``"selective_recompute"`` (or any
            registered policy whose mechanism is not the swap).
      depth: transfer-overlap depth (docs/transfer.md): how many
            residency moves may be in flight per channel, and how many
            chunk-level F+B slots ahead of its backward a restore is
            issued. ``depth=1`` is the classic serialized contract (one
            in-flight transient, one-slot prefetch — today's behavior,
            golden-pinned); deeper overlap hides slower links at the
            cost of ``depth-1`` extra in-flight units of device memory.
            Normalized to 1 when the residency policy moves no bytes
            over a channel (``none``, ``selective_recompute``).
      seq_chunks: sequence slices per microbatch (SlimPipe direction,
            docs/longcontext.md). ``seq_chunks=c > 1`` makes one slice
            the pipeline unit: forwards visit slices in causal order
            (slice i's attention reads the retained KV of slices < i),
            backwards run in reverse slice order, and activation stashes
            shrink to ~1/c of a microbatch plus the retained-KV prefix.
            Normalized to 1 for kinds without a sliced builder
            (``ScheduleKind.sliced`` — interleaved kinds cannot slice).
            ``seq_chunks=1`` is bit-identical to the unsliced engine.
      vocab_parallel: vocabulary-parallel degree (docs/memory.md "Vocab
            accounting"; arxiv 2411.05288 direction). ``vocab_parallel=
            vp > 1`` scatters the embedding table over the first vp
            stages and the LM head + fp32 logits over the last vp
            stages, trading the boundary-stage vocab memory spike for
            per-microbatch all-reduce/gather traffic on the boundary
            stages' F/B. Like ``depth``, a *pricing* dimension: the
            compiled streams and peak-stash accounting are those of the
            vp=1 structural twin (re-bound, never re-compiled); only
            the memory model's ``vocab_bytes`` split and the
            simulator's boundary-collective charge read it. Must
            satisfy ``1 <= vp <= p``; normalized to 1 when p == 1
            (nothing to scatter over). ``vocab_parallel=1`` is
            bit-identical to the unscattered engine.

    Specs are frozen and hashable — they key the compile cache and can be
    used as dict keys / set members anywhere a "schedule variant" is
    meant.
    """
    kind: str
    p: int
    m: int = 0
    v: int = 1
    cap: Optional[int] = None
    residency: str = "none"
    depth: int = 1
    seq_chunks: int = 1
    vocab_parallel: int = 1

    def __post_init__(self):
        entry = sched.SCHEDULES.get(self.kind)
        if entry is None:
            raise ValueError(
                f"unknown schedule kind {self.kind!r}; "
                f"registered: {sorted(sched.SCHEDULES)}")
        pol = respol.POLICIES.get(self.residency)
        if pol is None:
            raise ValueError(
                f"unknown residency policy {self.residency!r}; "
                f"registered: {sorted(respol.POLICIES)}")
        if entry.balanced:
            # balanced kinds ARE the swap policy (their builders emit
            # EVICT/LOAD); normalize so the spec says so, and reject a
            # contradictory residency rather than silently dropping it
            if self.residency not in ("none", respol.BPIPE_SWAP.name):
                raise ValueError(
                    f"{self.kind} embeds the partner swap; "
                    f"residency={self.residency!r} conflicts — use the "
                    f"unbalanced base kind for other policies")
            object.__setattr__(self, "residency", respol.BPIPE_SWAP.name)
            pol = respol.BPIPE_SWAP
        elif pol.swap:
            raise ValueError(
                f"residency {self.residency!r} is the balanced kinds' "
                f"built-in mechanism; use the bpipe twin of {self.kind!r}")
        if self.p < 1:
            raise ValueError(f"p must be >= 1, got {self.p}")
        if self.m < 0:
            raise ValueError(f"m must be >= 0, got {self.m}")
        if entry.interleaved:
            if self.v < 2:
                raise ValueError(
                    f"{self.kind} needs v >= 2 chunks, got v={self.v}")
            if self.m and self.m % self.p:
                raise ValueError(
                    f"{self.kind} needs m % p == 0, got m={self.m} p={self.p}")
        else:
            # plain kinds have exactly one chunk; normalize so the spec's
            # identity doesn't depend on a meaningless v knob
            object.__setattr__(self, "v", 1)
        if self.seq_chunks < 1:
            raise ValueError(
                f"seq_chunks must be >= 1, got {self.seq_chunks}")
        if self.seq_chunks != 1 and not entry.sliced:
            # kinds without a sliced builder (interleaved kinds — the
            # sliced ramp deadlocks against chunk-major unit order — and
            # plugin kinds that never opted in) run unsliced
            object.__setattr__(self, "seq_chunks", 1)
        # caps count sliced units, and the default bound widens by the
        # extra seq_chunks - 1 warmup slices (schedule.schedule_cap)
        cap_extra = self.seq_chunks - 1
        if entry.balanced:
            if self.cap is not None:
                if self.cap < 2:
                    raise ValueError(
                        f"cap must be >= 2 (one live forward + the "
                        f"in-flight LOAD transient), got {self.cap}")
                if self.cap == entry.default_cap(self.p, self.v) + cap_extra:
                    object.__setattr__(self, "cap", None)
        elif pol.active:
            if self.cap is not None:
                if self.cap < 2:
                    raise ValueError(
                        f"cap must be >= 2 (one live forward + the "
                        f"in-flight restore transient), got {self.cap}")
                if self.cap == pol.default_cap(self.p, self.v) + cap_extra:
                    object.__setattr__(self, "cap", None)
        else:
            object.__setattr__(self, "cap", None)
        if self.vocab_parallel < 1:
            raise ValueError(
                f"vocab_parallel must be >= 1, got {self.vocab_parallel}")
        if self.p == 1:
            # a single stage holds everything; nothing to scatter over
            object.__setattr__(self, "vocab_parallel", 1)
        elif self.vocab_parallel > self.p:
            raise ValueError(
                f"vocab_parallel={self.vocab_parallel} > p={self.p}: "
                f"vocab shards scatter over pipeline stages")
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {self.depth}")
        if not (entry.balanced or pol.moves_data):
            # depth is a *transfer* dimension: when the policy moves no
            # bytes over a channel (none, selective_recompute) there is
            # nothing to overlap — normalize so the knob is not a
            # spurious identity dimension
            object.__setattr__(self, "depth", 1)

    # -- derived identity ------------------------------------------------
    @property
    def entry(self) -> "sched.ScheduleKind":
        return sched.SCHEDULES[self.kind]

    @property
    def interleaved(self) -> bool:
        return self.entry.interleaved

    @property
    def balanced(self) -> bool:
        return self.entry.balanced

    @property
    def policy(self) -> "respol.ResidencyPolicy":
        """The residency policy governing where stashes live."""
        return respol.POLICIES[self.residency]

    @property
    def n_virtual(self) -> int:
        return self.p * self.v

    @property
    def resolved_cap(self) -> Optional[int]:
        """The effective per-device stash bound (None = unbounded). Caps
        count sliced units; defaults widen by seq_chunks - 1 (the extra
        sliced warmup ramp)."""
        extra = self.seq_chunks - 1
        if self.balanced:
            return self.cap if self.cap is not None \
                else self.entry.default_cap(self.p, self.v) + extra
        pol = self.policy
        if pol.active:
            return self.cap if self.cap is not None \
                else pol.default_cap(self.p, self.v) + extra
        return None

    @property
    def bound(self) -> bool:
        return self.m > 0

    def with_m(self, m: int) -> "ScheduleSpec":
        """Bind (or re-bind) the microbatch count."""
        return dataclasses.replace(self, m=m)

    # -- presentation / serialization -------------------------------------
    def label(self) -> str:
        bits = [self.kind, f"p={self.p}", f"m={self.m}"]
        if self.interleaved:
            bits.append(f"v={self.v}")
        if not self.balanced and self.policy.active:
            bits.append(f"res={self.residency}")
        if self.balanced or self.policy.active:
            bits.append(f"cap={self.cap if self.cap is not None else 'def'}")
        if self.depth != 1:
            bits.append(f"depth={self.depth}")
        if self.seq_chunks != 1:
            bits.append(f"c={self.seq_chunks}")
        if self.vocab_parallel != 1:
            bits.append(f"vp={self.vocab_parallel}")
        return " ".join(bits)

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "p": self.p, "m": self.m,
                "v": self.v, "cap": self.cap, "residency": self.residency,
                "depth": self.depth, "seq_chunks": self.seq_chunks,
                "vocab_parallel": self.vocab_parallel}

    #: Exactly the keys ``to_dict`` emits — ``from_dict`` rejects anything
    #: else so a typo'd or stale spec JSON fails loudly instead of
    #: silently dropping a dimension.
    DICT_KEYS = frozenset(("kind", "p", "m", "v", "cap", "residency",
                           "depth", "seq_chunks", "vocab_parallel"))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ScheduleSpec":
        unknown = sorted(set(d) - cls.DICT_KEYS)
        if unknown:
            raise ValueError(
                f"unknown ScheduleSpec keys {unknown}; "
                f"allowed: {sorted(cls.DICT_KEYS)}")
        return cls(kind=d["kind"], p=int(d["p"]), m=int(d.get("m", 0)),
                   v=int(d.get("v", 1)),
                   cap=None if d.get("cap") is None else int(d["cap"]),
                   residency=str(d.get("residency", "none")),
                   depth=int(d.get("depth", 1)),
                   seq_chunks=int(d.get("seq_chunks", 1)),
                   vocab_parallel=int(d.get("vocab_parallel", 1)))


# ---------------------------------------------------------------------------
# Compiled instructions
# ---------------------------------------------------------------------------
#: Phases of a residency move under the issue-early/complete-lazy
#: contract (docs/transfer.md): the ISSUE half starts the transfer as
#: soon as its dependency is ready, the WAIT half blocks the dependent
#: compute until the transfer really completed. Compute ops (F/B) carry
#: the empty phase.
ISSUE, WAIT = "issue", "wait"


@dataclasses.dataclass(frozen=True)
class PlannedInstr:
    """One schedule instruction with its dispatch context resolved at
    compile time: the virtual stage it runs on, the upstream completion
    it waits for (``dep``), and whether that dependency crosses a device
    boundary (``dep_hop`` — the p2p transfer the simulator charges and a
    multi-host runtime would device_put).

    Residency moves are compiled into two halves (``phase``): the ISSUE
    half (dep: what the move waits for — the unit's own F for a
    release, the release's completion for a restore) and the WAIT half
    (dep: the move's own completion), placed where the completion is
    consumed. Both halves share the op name and publish/consume the
    same canonical ``done_key``."""
    op: str
    stage: int
    mb: int
    chunk: int
    vs: int                        # virtual stage = chunk * p + stage
    dep: Optional[DepKey] = None   # (op, stage, mb, chunk, sl) upstream
    dep_hop: bool = False
    phase: str = ""                # "", ISSUE or WAIT
    sl: int = 0                    # sequence slice (seq_chunks > 1 only)

    @property
    def key(self) -> Tuple[int, int, int, int]:
        return (self.stage, self.mb, self.chunk, self.sl)

    @property
    def done_key(self) -> DepKey:
        """The completion record this instruction publishes."""
        return (self.op, self.stage, self.mb, self.chunk, self.sl)

    @property
    def is_wait(self) -> bool:
        return self.phase == WAIT

    def as_instr(self) -> Instr:
        return Instr(self.op, self.mb, self.chunk, self.sl)

    def __repr__(self):
        c = f".c{self.chunk}" if self.chunk else ""
        s = f".s{self.sl}" if self.sl else ""
        w = "+w" if self.phase == WAIT else ""
        return f"{self.op}{self.mb}{c}{s}{w}@{self.stage}"


def _plan_stream(spec: ScheduleSpec, stage: int,
                 raw: Sequence[Instr]) -> Tuple[PlannedInstr, ...]:
    """Resolve each raw instruction's dependency edge and device hop.

    Every dependency shares the instruction's sequence slice: a sliced
    F(mb, sl) consumes the previous virtual stage's F of the SAME slice,
    and the causal order across slices (slice i's attention reads the
    retained KV of slices < i on the same stage) is already program
    order within the stage's stream, so it needs no extra edge."""
    p, nv = spec.p, spec.n_virtual
    out: List[PlannedInstr] = []
    for ins in raw:
        vs = sched.virtual_stage(stage, ins.chunk, p)
        dep: Optional[DepKey] = None
        hop = False
        if ins.op == F:
            if vs > 0:
                pi, pc = (vs - 1) % p, (vs - 1) // p
                dep = (F, pi, ins.mb, pc, ins.sl)
                hop = pi != stage
        elif ins.op == B:
            if vs == nv - 1:
                dep = (F, stage, ins.mb, ins.chunk, ins.sl)  # own forward
            else:
                ni, nc = (vs + 1) % p, (vs + 1) // p
                dep = (B, ni, ins.mb, nc, ins.sl)
                hop = ni != stage
        elif ins.op in respol.RELEASE_OPS:
            # any residency release (EVICT/OFFLOAD/DROP/...) waits on the
            # unit's own forward
            dep = (F, stage, ins.mb, ins.chunk, ins.sl)
        elif ins.op in respol.RESTORE_OPS:
            # any restore (LOAD/FETCH/RECOMPUTE/...) waits on its release
            dep = (respol.RESTORE_OPS[ins.op].release_op,
                   stage, ins.mb, ins.chunk, ins.sl)
        else:
            raise ValueError(f"unknown op {ins.op!r}")
        out.append(PlannedInstr(ins.op, stage, ins.mb, ins.chunk, vs,
                                dep, hop, sl=ins.sl))
    return tuple(out)


def _split_stream(stream: Sequence[PlannedInstr]) -> Tuple[PlannedInstr, ...]:
    """Split every residency move into its ISSUE/WAIT halves.

    Placement is the issue-early/complete-lazy contract:
      * a release's ISSUE sits where the move sat (right after the
        covering forward — the earliest its data exists); its WAIT sits
        immediately before the matching restore's ISSUE, the first point
        its completion is consumed;
      * a restore's ISSUE sits where the move sat and its WAIT directly
        after — i.e. just before the backward that needs the data.

    Positions of compute ops (and of the canonical move events) are
    unchanged, so the depth-1 engine prices exactly the serialized
    timeline this refactor replaced (golden-pinned), and the stash/spill
    accounting runs on the unsplit stream and stays bit-identical.
    """
    out: List[PlannedInstr] = []
    pending: Dict[Tuple[str, int, int, int], PlannedInstr] = {}
    for ins in stream:
        if ins.op in respol.RELEASE_OPS:
            out.append(dataclasses.replace(ins, phase=ISSUE))
            pending[(ins.op, ins.mb, ins.chunk, ins.sl)] = dataclasses.replace(
                ins, phase=WAIT, dep=ins.done_key, dep_hop=False)
        elif ins.op in respol.RESTORE_OPS:
            rel = respol.RESTORE_OPS[ins.op].release_op
            rel_wait = pending.pop((rel, ins.mb, ins.chunk, ins.sl), None)
            if rel_wait is not None:
                out.append(rel_wait)
            out.append(dataclasses.replace(ins, phase=ISSUE))
            out.append(dataclasses.replace(ins, phase=WAIT,
                                           dep=ins.done_key, dep_hop=False))
        else:
            out.append(ins)
    # a release with no restore cannot occur in a well-formed stream, but
    # tolerate it (its wait becomes a trailing barrier) rather than drop
    out.extend(pending.values())
    return tuple(out)


# ---------------------------------------------------------------------------
# The compiled artifact
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Schedule:
    """Everything a schedule consumer needs, computed once per spec.

    ``streams`` carry resolved deps/hops, with every residency move
    split into its ISSUE/WAIT halves (``PlannedInstr.phase`` — the
    transfer-engine IR, docs/transfer.md); ``partner`` is the BPipe
    evictor<->acceptor map (empty for unbalanced kinds); ``cap`` is the
    resolved uniform bound (None = unbounded); ``bounds`` the per-stage
    live-store assertion bound the executor enforces (the schedule's own
    per-stage peak under a custom cap — a tighter evictor cap
    legitimately raises the acceptor's peak above the uniform number);
    ``peak_stash`` the per-stage peak unit count (local + accepted
    foreign) that feeds the memory model and planner feasibility;
    ``peak_spilled`` the per-stage peak count of units released off the
    device store by a non-swap residency policy (host-resident for
    offload, residual-freed for recompute — byte-weighted per policy by
    the memory model); ``num_evictions``/``num_loads`` the per-stage
    release/restore op counts (EVICT/LOAD for the swap, OFFLOAD/FETCH,
    DROP/RECOMPUTE, ...) that feed traffic accounting.
    """
    spec: ScheduleSpec
    streams: Mapping[int, Tuple[PlannedInstr, ...]]
    partner: Mapping[int, int]
    cap: Optional[int]
    bounds: Mapping[int, Optional[int]]
    peak_stash: Mapping[int, int]
    num_evictions: Mapping[int, int]
    num_loads: Mapping[int, int]
    peak_spilled: Mapping[int, int] = dataclasses.field(default_factory=dict)

    @property
    def p(self) -> int:
        return self.spec.p

    @property
    def n_virtual(self) -> int:
        return self.spec.n_virtual

    @property
    def size(self) -> int:
        return sum(len(s) for s in self.streams.values())

    @property
    def moves(self) -> int:
        """Total EVICT + LOAD instructions over one step."""
        return (sum(self.num_evictions.values())
                + sum(self.num_loads.values()))

    def instr_streams(self) -> Dict[int, List[Instr]]:
        """The raw-``Instr`` view (the pre-compile IR, for legacy callers
        and stream-shape tests): WAIT halves collapse away and each move
        appears once, at its ISSUE position — exactly the pre-split
        stream shape (golden-pinned)."""
        return {i: [pi.as_instr() for pi in s if not pi.is_wait]
                for i, s in self.streams.items()}


def partner_map(p: int) -> Dict[int, int]:
    """BPipe evictor<->acceptor pairing as a symmetric map."""
    out: Dict[int, int] = {}
    for a, b in sched.bpipe_pairs(p):
        out[a] = b
        out[b] = a
    return out


#: Bounded LRU over compiled plans. A dict (insertion-ordered) rather
#: than ``functools.lru_cache`` so the planner can read hit/miss/bind
#: counters (``compile_cache_stats`` / ``launch.plan --verbose``) and so
#: depth re-binds share one structural compilation (see below).
_COMPILE_CACHE: Dict[ScheduleSpec, Schedule] = {}
_COMPILE_CACHE_MAX = 256
_COMPILE_STATS = {"hits": 0, "misses": 0, "evictions": 0, "binds": 0}


def compile_plan(spec: ScheduleSpec) -> Schedule:
    """Compile ``spec`` into a ``Schedule``. Cached on the spec (bounded
    LRU) — the planner's feasibility pass, the simulator, and the
    executor all share one compilation per variant.

    ``depth`` and ``vocab_parallel`` are *pricing* dimensions: they
    change what the simulator charges (and what the executor keeps in
    flight / how vocab shards lay out), never the compiled streams or
    peak-stash accounting. Specs that differ only in those knobs
    therefore share one structural compilation — the depth-1/vp-1
    artifact is compiled once and re-bound (``dataclasses.replace`` of
    the spec field) per knob setting, so a planner depth or
    vocab-parallel ladder costs one compile."""
    cached = _COMPILE_CACHE.get(spec)
    if cached is not None:
        _COMPILE_STATS["hits"] += 1
        # move-to-back = most recently used (dicts iterate in insertion
        # order, so the front is the eviction victim)
        _COMPILE_CACHE.pop(spec)
        _COMPILE_CACHE[spec] = cached
        return cached
    _COMPILE_STATS["misses"] += 1
    if spec.depth != 1 or spec.vocab_parallel != 1:
        base = compile_plan(dataclasses.replace(spec, depth=1,
                                                vocab_parallel=1))
        _COMPILE_STATS["binds"] += 1
        sch = dataclasses.replace(base, spec=spec)
    else:
        sch = _compile(spec)
    _COMPILE_CACHE[spec] = sch
    while len(_COMPILE_CACHE) > _COMPILE_CACHE_MAX:
        _COMPILE_CACHE.pop(next(iter(_COMPILE_CACHE)))
        _COMPILE_STATS["evictions"] += 1
    return sch


def _compile_cache_clear() -> None:
    _COMPILE_CACHE.clear()


compile_plan.cache_clear = _compile_cache_clear


def compile_cache_stats(reset: bool = False) -> Dict[str, int]:
    """Compile-cache counters: ``hits``/``misses`` (cache lookups),
    ``binds`` (misses served by re-binding a cached depth-1 structural
    template instead of compiling), ``evictions``, and the current
    ``size``/``maxsize``. ``reset=True`` zeroes the counters after
    reading (the cache itself is untouched)."""
    out = dict(_COMPILE_STATS, size=len(_COMPILE_CACHE),
               maxsize=_COMPILE_CACHE_MAX)
    if reset:
        for k in _COMPILE_STATS:
            _COMPILE_STATS[k] = 0
    return out


#: Peak accounting saturates in m: every registered kind that opts in
#: (``ScheduleKind.peak_saturates``) reaches its steady-state 1F1B
#: cadence within the warmup ramp, after which per-stage peak stash /
#: spill counts and load-positivity are m-independent. 4*p*seq_chunks is
#: comfortably past every builder's warmup (max (v+1)p-ish) and is
#: divisible by p, so it is a valid interleaved m. Verified by a grid
#: property test (tests/test_planner_bnb.py).
PEAK_SATURATION_FACTOR = 4


def peak_template_spec(spec: ScheduleSpec) -> ScheduleSpec:
    """The cheapest spec with identical per-stage peak accounting
    (``peak_stash``/``peak_spilled``/``bounds`` and load-positivity) —
    ``spec`` itself unless its kind saturates and m is past the
    saturation point, in which case m binds down to the saturation
    template. Feasibility-style consumers (``memory_model``) compile the
    template instead of the full stream; consumers that need the actual
    instruction streams or move *counts* must compile ``spec``."""
    entry = spec.entry
    if not entry.peak_saturates or not spec.bound:
        return spec
    msat = PEAK_SATURATION_FACTOR * spec.p * spec.seq_chunks
    if spec.m <= msat:
        return spec
    return dataclasses.replace(spec, m=msat)


def _compile(spec: ScheduleSpec) -> Schedule:
    if not spec.bound:
        raise ValueError(f"cannot compile unbound spec (m=0): {spec}")
    p = spec.p
    entry = spec.entry
    pol = spec.policy
    cap = spec.resolved_cap

    def raw(i: int) -> sched.Stream:
        base = entry.stream(p, spec.m, i, spec.v, spec.cap, spec.seq_chunks)
        if entry.balanced or not pol.active:
            # balanced builders embed their own spill (EVICT/LOAD)
            return base
        return pol.rewrite(base, cap)

    unsplit = {i: _plan_stream(spec, i, raw(i)) for i in range(p)}
    partner = partner_map(p) if spec.balanced else {}
    # Stash/spill accounting runs on the UNSPLIT streams: the split only
    # makes completion explicit, it does not move any residency event,
    # and accounting on the pre-split order keeps the round-robin merge
    # (and with it every golden-pinned peak) bit-identical.
    traces, spill_traces, counts = _account(unsplit, p, partner)
    streams = {i: _split_stream(unsplit[i]) for i in range(p)}
    peaks = {i: (max(t) if t else 0) for i, t in traces.items()}
    spilled = {i: (max(t) if t else 0) for i, t in spill_traces.items()}
    releases = {i: sum(1 for x in unsplit[i] if x.op in respol.RELEASE_OPS)
                for i in range(p)}
    restores = {i: sum(1 for x in unsplit[i] if x.op in respol.RESTORE_OPS)
                for i in range(p)}
    if cap is None:
        bounds: Dict[int, Optional[int]] = {i: None for i in range(p)}
    elif spec.cap is not None:
        bounds = dict(peaks)
    else:
        bounds = {i: cap for i in range(p)}
    return Schedule(spec=spec, streams=streams, partner=partner, cap=cap,
                    bounds=bounds, peak_stash=peaks,
                    num_evictions=releases, num_loads=restores,
                    peak_spilled=spilled)


def num_moves(spec: ScheduleSpec) -> int:
    """Total release + restore instructions one step of ``spec``
    performs (EVICT+LOAD, OFFLOAD+FETCH, DROP+RECOMPUTE, ...) — the
    count the planner charges bandwidth (or recompute FLOPs) with.
    Covers every balanced kind, residency policy and cap override (the
    counts come from the stream actually built, not a closed form); 0
    when nothing manages residency."""
    if not spec.balanced and not spec.policy.active:
        return 0
    return compile_plan(spec).moves


# ---------------------------------------------------------------------------
# The dispatch engine
# ---------------------------------------------------------------------------
class ScheduleDeadlock(RuntimeError):
    """No stage can make progress: a dependency cycle or a handler that
    blocks forever. Carries the per-stage program counters for debugging."""

    def __init__(self, idx: Mapping[int, int],
                 streams: Mapping[int, Sequence[Any]]):
        self.idx = dict(idx)
        stuck = {i: repr(streams[i][j]) for i, j in idx.items()
                 if j < len(streams[i])}
        super().__init__(f"schedule deadlock; next instruction per stage: "
                         f"{stuck}")


#: Sentinel a handler returns when its instruction's inputs are not ready
#: yet; the engine moves on to the next stage and retries later.
BLOCKED = object()

Handler = Callable[[int, Any], Any]


def run(streams: Mapping[int, Sequence[Any]],
        handlers: Mapping[str, Handler], *, greedy: bool = True,
        observer: Optional[Any] = None, dep_gated: bool = False) -> int:
    """The ready-instruction dispatch loop — the ONLY scheduling loop in
    the codebase. Simulator, executor, and stash accounting are handler
    sets over it.

    Each stage's stream is consumed in order; ``handlers[op](stage, ins)``
    executes one instruction or returns ``BLOCKED`` to signal that an
    upstream input has not been produced yet. ``greedy=True`` drains each
    stage as far as it can go per round (dataflow consumers: simulator,
    executor); ``greedy=False`` takes at most one instruction per stage
    per round — the deterministic round-robin merge the stash accounting
    counts over. A full round with no progress raises
    ``ScheduleDeadlock``. Returns the number of instructions dispatched.

    ``dep_gated=True`` selects the event-driven engine for compiled
    ``PlannedInstr`` streams whose handlers block exactly when
    ``ins.dep`` has not retired (the simulator and the executor): stages
    park on their head instruction's unretired dep and are re-queued by
    the retirement that satisfies it, instead of the engine re-scanning
    every stream every round. Dispatch order is bit-identical to the
    scan loop for both greedy and round-robin modes (property-pinned in
    tests). The default scan path remains for handler sets that do not
    follow the dep discipline — the stash accounting's blind round-robin
    counting merge, and raw ``Instr`` streams with no dep edges.

    ``observer`` (the ``repro_torch.obs.events.Observer`` contract, duck-typed)
    gets a ``dispatch(stage, ins)`` callback for every instruction the
    loop retires, in engine order — the one seam every event stream
    (simulator timelines, executor traces, dispatch-order audits) hangs
    off. ``None`` (the default) is zero-cost: the loop body is exactly
    the pre-instrumentation code path.
    """
    if dep_gated:
        return _run_events(streams, handlers, greedy=greedy,
                           observer=observer)
    stages = sorted(streams)
    idx = {i: 0 for i in stages}
    remaining = sum(len(streams[i]) for i in stages)
    done = 0
    while remaining:
        progressed = False
        for i in stages:
            stream = streams[i]
            while idx[i] < len(stream):
                ins = stream[idx[i]]
                if handlers[ins.op](i, ins) is BLOCKED:
                    break
                idx[i] += 1
                remaining -= 1
                done += 1
                progressed = True
                if observer is not None:
                    observer.dispatch(i, ins)
                if not greedy:
                    break
        if not progressed:
            raise ScheduleDeadlock(idx, streams)
    return done


def _run_events(streams: Mapping[int, Sequence[Any]],
                handlers: Mapping[str, Handler], *, greedy: bool = True,
                observer: Optional[Any] = None) -> int:
    """Event-driven dispatch over dep-resolved streams (``run`` with
    ``dep_gated=True``).

    A stage whose head instruction's ``dep`` has not retired parks in
    ``waiting`` under that dep key; the dispatch that publishes the key
    re-queues every parked waiter. Two min-heaps replay the scan loop's
    visit order exactly: ``cur`` holds the stages still to visit this
    sweep (= one ``for i in stages`` round of the scan loop), ``nxt``
    the stages runnable next sweep. A waiter ``j`` woken while the
    cursor is at stage ``i`` goes to ``cur`` iff ``j > i`` — in the
    scan loop, exactly those stages would still be visited in the same
    round — else to ``nxt``. Both heaps empty with instructions
    remaining (or a full sweep of handler-level ``BLOCKED`` refusals,
    which the dep discipline says cannot happen) is the same deadlock
    the scan loop diagnoses.
    """
    idx = {i: 0 for i in streams}
    remaining = sum(len(s) for s in streams.values())
    done = 0
    retired: set = set()
    waiting: Dict[Any, List[int]] = {}
    cur = [i for i in streams if streams[i]]
    heapq.heapify(cur)
    nxt: List[int] = []
    push, pop = heapq.heappush, heapq.heappop
    while remaining:
        progressed = False
        while cur:
            i = pop(cur)
            stream = streams[i]
            n = len(stream)
            while idx[i] < n:
                ins = stream[idx[i]]
                dep = ins.dep
                if dep is not None and dep not in retired:
                    waiting.setdefault(dep, []).append(i)
                    break
                if handlers[ins.op](i, ins) is BLOCKED:
                    # a handler refusing a dep-retired instruction is
                    # outside the dep_gated contract; retry next sweep
                    # (a whole sweep of refusals raises below, exactly
                    # like a no-progress scan round)
                    push(nxt, i)
                    break
                idx[i] += 1
                remaining -= 1
                done += 1
                progressed = True
                retired.add(ins.done_key)
                for j in waiting.pop(ins.done_key, ()):
                    push(cur if j > i else nxt, j)
                if observer is not None:
                    observer.dispatch(i, ins)
                if not greedy:
                    if idx[i] < n:
                        dep = stream[idx[i]].dep
                        if dep is None or dep in retired:
                            push(nxt, i)
                        else:
                            waiting.setdefault(dep, []).append(i)
                    break
        if remaining and (not progressed or not nxt):
            raise ScheduleDeadlock(idx, streams)
        cur, nxt = nxt, cur
    return done


def _account(streams: Mapping[int, Sequence[Any]], p: int,
             partner: Optional[Mapping[int, int]] = None,
             ) -> Tuple[Dict[int, List[int]], Dict[int, List[int]],
                        Dict[int, int]]:
    """Replay ``streams`` through the engine with counting handlers for
    the full registered op set.

    Returns ``(traces, spill_traces, counts)``: per-stage traces of
    device-resident stashed-unit counts after each event (including
    foreign stashes accepted from the paired evictor), per-stage traces
    of units spilled OFF the device store by a non-swap policy
    (host-resident / residual-freed), and the final device counts (all
    zero for a well-formed schedule). Works on raw ``Instr`` and
    compiled ``PlannedInstr`` streams alike — the handlers read ``op``
    plus (when present) the ISSUE/WAIT ``phase``: a move counts once, at
    its ISSUE half; WAIT halves are completion barriers, not events.
    """
    partner = partner_map(p) if partner is None else partner
    counts = {i: 0 for i in range(p)}
    spilled = {i: 0 for i in range(p)}
    traces: Dict[int, List[int]] = {i: [] for i in range(p)}
    spill_traces: Dict[int, List[int]] = {i: [] for i in range(p)}

    def bump(i: int, delta: int) -> None:
        counts[i] += delta
        traces[i].append(counts[i])

    def on_f(i, ins):
        bump(i, +1)

    def on_b(i, ins):
        bump(i, -1)

    def on_release(i, ins):
        if getattr(ins, "phase", "") == WAIT:
            return None
        counts[i] -= 1
        if respol.RELEASE_OPS[ins.op].swap:
            if i not in partner:
                # the unpaired middle stage of an odd-p bpipe ring: a cap
                # tight enough to make it spill has nowhere to swap to
                raise ValueError(
                    f"cap forces stage {i} to evict but it has no swap "
                    f"partner (odd p): unbalanceable")
            counts[partner[i]] += 1
            traces[partner[i]].append(counts[partner[i]])
        else:
            spilled[i] += 1
            spill_traces[i].append(spilled[i])
        traces[i].append(counts[i])

    def on_restore(i, ins):
        if getattr(ins, "phase", "") == WAIT:
            return None
        counts[i] += 1
        if respol.RESTORE_OPS[ins.op].swap:
            counts[partner[i]] -= 1
            traces[partner[i]].append(counts[partner[i]])
        else:
            spilled[i] -= 1
            spill_traces[i].append(spilled[i])
        traces[i].append(counts[i])

    handlers: Dict[str, Handler] = {F: on_f, B: on_b}
    for op in respol.RELEASE_OPS:
        handlers[op] = on_release
    for op in respol.RESTORE_OPS:
        handlers[op] = on_restore
    run(streams, handlers, greedy=False)
    return traces, spill_traces, counts


def stash_accounting(streams: Mapping[int, Sequence[Any]], p: int,
                     partner: Optional[Mapping[int, int]] = None,
                     ) -> Tuple[Dict[int, List[int]], Dict[int, int]]:
    """Device-resident stash accounting (the legacy two-tuple view of
    ``_account`` — spill traces are the compiled ``Schedule``'s
    ``peak_spilled`` business)."""
    traces, _, counts = _account(streams, p, partner)
    return traces, counts
