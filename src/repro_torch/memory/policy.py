"""Activation-residency policies: where a stashed activation lives
between its F and its B.

The paper's central comparison (§4, Table 3) is a three-way contest
between residency strategies — BPipe's partner swap vs. recomputation
vs. footprint reduction — and related systems (SlimPipe's activation
offloading, controllable-memory pipelines) show residency is an axis
*orthogonal* to the schedule kind. This module makes it one:

  * ``ResidencyPolicy`` — the declarative contract: which ops release a
    local stash slot and restore it before the backward, how the spilled
    unit is moved (partner swap / host copy / re-forward), what device
    bytes a released unit still retains, and the cap formulas the
    planner's cap search needs.
  * ``spill(base, cap, release_op, restore_op)`` — the one cap-driven
    stream rewrite (re-homed from ``schedule._balance``): whenever the
    local stash would exceed ``cap`` (including the in-flight restore
    transient), the unit whose backward is farthest away (the newest
    held) is released right after a forward and restored just before its
    own backward. Every policy shares it, so ``bpipe_swap`` stays
    bit-identical to the pre-refactor BPipe streams and the new policies
    inherit exactly the same spill discipline.
  * ``POLICIES`` / ``register`` — the registry that extends the op set:
    ``plan._plan_stream`` derives dependency edges, ``plan`` derives the
    accounting handlers, and the simulator derives pricing handlers from
    the registered policies, so registering one here is the ONE step
    that makes a residency mechanism compilable, simulable, executable
    and plannable (docs/memory.md).

Built-in policies: ``none``, ``bpipe_swap`` (here), ``host_offload``
(``repro_torch.memory.offload``), ``selective_recompute``
(``repro_torch.memory.recompute``).
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Dict, Optional

from repro_torch.core import schedule as sched
from repro_torch.core.notation import Notation
from repro_torch.core.schedule import B, EVICT, F, Instr, LOAD, Stream

#: Residency mechanisms (``ResidencyPolicy.mechanism``):
#:   none      - the unit stays in the local store until its B
#:   swap      - released units land on the BPipe partner stage (EVICT/LOAD)
#:   host      - released units are copied to host memory (OFFLOAD/FETCH)
#:   recompute - released units free their residuals; the restore re-runs
#:               the forward from the retained boundary input (DROP/RECOMPUTE)
MECHANISMS = ("none", "swap", "host", "recompute")


def spill(base: Stream, cap: int, release_op: str, restore_op: str) -> Stream:
    """The cap-driven residency rewrite over any F/B stream: whenever the
    local stash would exceed ``cap`` (including the in-flight restore
    transient), the unit whose backward is farthest away (the newest
    held) is released right after a forward, and restored just before
    its own backward. Units are (mb, chunk, sl) — a sequence-sliced
    stream's slices spill independently, like any other unit. With
    ``(release_op, restore_op) = (EVICT, LOAD)`` this is exactly BPipe's
    continuous balancing (``schedule._balance``)."""
    released: set = set()
    held: list = []                   # local stash, oldest first
    out: Stream = []
    for pos, ins in enumerate(base):
        key = (ins.mb, ins.chunk, ins.sl)
        if ins.op == F:
            # Will the next backward's restore land while this F's output
            # is still held? Then budget one extra slot for it.
            nxt = base[pos + 1] if pos + 1 < len(base) else None
            pending = 1 if (nxt is not None and nxt.op == B
                            and (nxt.mb, nxt.chunk, nxt.sl) in released) \
                else 0
            # Proactively make room *before* computing the forward.
            while len(held) + 1 + pending > cap:
                vmb, vchunk, vsl = held.pop()   # newest held
                out.append(Instr(release_op, vmb, vchunk, vsl))
                released.add((vmb, vchunk, vsl))
            out.append(ins)
            held.append(key)
        else:  # B
            if key in released:
                out.append(Instr(restore_op, ins.mb, ins.chunk, ins.sl))
                released.discard(key)
                held.append(key)
            out.append(ins)
            held.remove(key)
    return out


def residency_cap(p: int, v: int = 1) -> int:
    """The default local-stash bound a capped residency policy balances
    to: the BPipe bound (the same per-device number the paper's pairing
    achieves), generalized to v chunks."""
    return sched.bpipe_cap(p) if v <= 1 else sched.bpipe_interleaved_cap(p, v)


def residency_cap_roof(p: int, m: int, v: int = 1) -> int:
    """Cap above which the rewrite degenerates to the base schedule
    (stage-0 1F1B peak) — bounds the planner's cap search."""
    if v <= 1:
        return max(min(p, m), 2)
    return max(sched.interleaved_peak(p, m, 0, v), 2)


def _no_retained(n: Notation, attention: str, v: int) -> float:
    return 0.0


@dataclasses.dataclass(frozen=True)
class ResidencyPolicy:
    """Everything the system needs to know about one residency mechanism.

    Fields:
      name:        registry key (``ScheduleSpec.residency``).
      release_op / restore_op:
                   the op pair the spill rewrite emits (None for the
                   ``none`` policy). ``plan`` derives dependency edges
                   (release depends on the unit's own F, restore on its
                   release) and the stash/spill accounting from these.
      mechanism:   how a released unit is realized — "swap" (partner
                   store), "host" (D2H/H2D copy), "recompute" (free the
                   residuals, re-forward at restore). Drives the
                   simulator's pricing handler and the executor's store
                   operation for the op pair.
      default_cap: ``(p, v) -> int`` local-stash bound the rewrite
                   balances to when the spec does not override it.
      cap_roof:    ``(p, m, v) -> int`` cap above which the rewrite is a
                   no-op (planner cap-search clamp).
      retained_bytes:
                   ``(n, attention, v) -> float`` device bytes one
                   released unit STILL occupies (recompute keeps the
                   boundary input it re-forwards from; swap/host keep
                   nothing locally) — ``memory_model`` charges it.
      moves_data:  release/restore copy the unit's bytes over a link
                   (False for recompute: the restore costs FLOPs, not
                   bandwidth).
    """
    name: str
    release_op: Optional[str] = None
    restore_op: Optional[str] = None
    mechanism: str = "none"
    default_cap: Optional[Callable[[int, int], int]] = None
    cap_roof: Optional[Callable[[int, int, int], int]] = None
    retained_bytes: Callable[[Notation, str, int], float] = _no_retained

    def __post_init__(self):
        if self.mechanism not in MECHANISMS:
            raise ValueError(
                f"{self.name}: unknown mechanism {self.mechanism!r}; "
                f"one of {MECHANISMS}")
        if self.active and (self.release_op is None or self.restore_op is None
                            or self.default_cap is None
                            or self.cap_roof is None):
            raise ValueError(
                f"{self.name}: active policies need release_op/restore_op "
                f"and default_cap/cap_roof — the rewrite and the planner's "
                f"cap search depend on all four")

    @property
    def active(self) -> bool:
        """Does this policy rewrite streams at all?"""
        return self.mechanism != "none"

    @property
    def swap(self) -> bool:
        return self.mechanism == "swap"

    @property
    def moves_data(self) -> bool:
        """Release/restore copy bytes over a link (vs. re-running FLOPs)."""
        return self.mechanism in ("swap", "host")

    def rewrite(self, base: Stream, cap: int) -> Stream:
        """Insert this policy's release/restore ops into a base stream,
        keeping the local stash within ``cap``."""
        if not self.active:
            return list(base)
        return spill(base, cap, self.release_op, self.restore_op)


# ---------------------------------------------------------------------------
# The registry — op-set extension point
# ---------------------------------------------------------------------------
POLICIES: Dict[str, ResidencyPolicy] = {}

# op -> policy maps, rebuilt on every register/unregister; ``plan`` and
# the simulator derive dependency edges, accounting and pricing handlers
# from these, so a registered policy's ops are immediately dispatchable.
RELEASE_OPS: Dict[str, ResidencyPolicy] = {}
RESTORE_OPS: Dict[str, ResidencyPolicy] = {}


def _rebuild_derived() -> None:
    RELEASE_OPS.clear()
    RESTORE_OPS.clear()
    for pol in POLICIES.values():
        if not pol.active:
            continue
        RELEASE_OPS[pol.release_op] = pol
        RESTORE_OPS[pol.restore_op] = pol


def _clear_plan_cache() -> None:
    # Deferred AND guarded: policies register while repro_torch.core.plan may
    # still be mid-import (plan imports this module at its top).
    plan = sys.modules.get("repro_torch.core.plan")
    if plan is not None and hasattr(plan, "compile_plan"):
        plan.compile_plan.cache_clear()


def register(pol: ResidencyPolicy, replace: bool = False) -> ResidencyPolicy:
    """Register a residency policy. Its ops become compilable (dependency
    edges + accounting in ``plan``), simulable (priced by mechanism) and
    plannable (``planner.space`` cap ladder) with no interpreter edits."""
    if pol.name in POLICIES and not replace:
        raise ValueError(f"residency policy {pol.name!r} already registered")
    if pol.active:
        for other in POLICIES.values():
            if other.name == pol.name or not other.active:
                continue
            if {pol.release_op, pol.restore_op} \
                    & {other.release_op, other.restore_op}:
                raise ValueError(
                    f"{pol.name}: ops collide with {other.name}")
    POLICIES[pol.name] = pol
    _rebuild_derived()
    _clear_plan_cache()
    return pol


def unregister(name: str) -> None:
    """Remove a registered policy (tests / plugin teardown)."""
    POLICIES.pop(name, None)
    _rebuild_derived()
    _clear_plan_cache()


def get(name: str) -> ResidencyPolicy:
    pol = POLICIES.get(name)
    if pol is None:
        raise ValueError(f"unknown residency policy {name!r}; "
                         f"registered: {sorted(POLICIES)}")
    return pol


NONE = register(ResidencyPolicy("none"))

#: The paper's mechanism, re-homed: EVICT ships the newest held unit to
#: the paired acceptor stage, LOAD fetches it back ahead of its backward.
#: The balanced schedule kinds (bpipe / bpipe_interleaved) embed this
#: policy — their builders call ``spill`` with this op pair, and
#: ``ScheduleSpec`` normalizes their residency field to this name.
BPIPE_SWAP = register(ResidencyPolicy(
    "bpipe_swap", EVICT, LOAD, mechanism="swap",
    default_cap=residency_cap, cap_roof=residency_cap_roof))
