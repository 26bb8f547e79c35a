"""The planner's search space: candidate (kind, residency, v, b, m, cap,
attention) plans for one (model, p, t, B, s) training configuration.

A candidate is everything the user would otherwise pick by hand per
config. Enumeration applies only *structural* constraints (b | B,
interleaving's m % p == 0 and v >= 2, p*v <= num_layers, cap >= 2);
memory pruning is ``planner.feasibility``'s job and cost ranking is
``planner.rank``'s, so each stage of the funnel is testable alone.

Residency is a real dimension: unbalanced kinds pair with every policy
in ``SearchSpace.residencies`` (each active policy opening its own cap
ladder), while balanced kinds carry their built-in ``bpipe_swap`` — so
the planner's three-way contest (swap vs. offload vs. recompute, the
paper's Table 3 story) falls out of one enumeration instead of
hard-coded arms.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

from repro_torch.core import plan as P
from repro_torch.core import schedule as sched
from repro_torch.core.notation import Notation
from repro_torch.memory import policy as respol

ATTENTION_ARMS = ("none", "recompute", "flash")


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point of the search space: a schedule variant plus the two
    knobs that are not the schedule's identity (micro batch size and
    attention arm). ``spec(p)`` yields the compiled-plan identity every
    downstream stage consumes.

    ``cap`` is None when nothing caps the stash and for the default
    bound (``schedule_cap`` / the policy's ``default_cap``); a
    planner-chosen override otherwise. ``v`` is 1 for plain kinds.
    ``residency`` is the activation-residency policy (balanced kinds
    carry their built-in ``bpipe_swap``). ``depth`` is the
    transfer-overlap depth (docs/transfer.md): how many residency moves
    may be in flight per channel — deeper overlap hides slower links at
    the cost of (depth - 1) extra in-flight units of device memory,
    which the feasibility pass charges.
    """
    kind: str
    b: int
    m: int
    v: int = 1
    cap: Optional[int] = None
    attention: str = "recompute"
    residency: str = "none"
    depth: int = 1
    seq_chunks: int = 1
    vocab_parallel: int = 1

    def spec(self, p: int) -> P.ScheduleSpec:
        """The candidate's schedule variant on a p-stage pipeline."""
        return P.ScheduleSpec(self.kind, p, self.m, v=self.v, cap=self.cap,
                              residency=self.residency, depth=self.depth,
                              seq_chunks=self.seq_chunks,
                              vocab_parallel=self.vocab_parallel)

    def label(self) -> str:
        bits = [self.kind, f"b={self.b}", f"m={self.m}"]
        if self.kind in sched.INTERLEAVED:
            bits.append(f"v={self.v}")
        if self.seq_chunks != 1:
            bits.append(f"c={self.seq_chunks}")
        if self.vocab_parallel != 1:
            bits.append(f"vp={self.vocab_parallel}")
        if self.residency not in ("none", "bpipe_swap"):
            bits.append(f"res={self.residency}")
        if self.cap is not None:
            bits.append(f"cap={self.cap}")
        if self.depth != 1:
            bits.append(f"d={self.depth}")
        bits.append(self.attention)
        return " ".join(bits)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Which axes to sweep. Defaults mirror the paper's experiment grid
    plus the beyond-paper interleaved kinds and residency policies."""
    kinds: Tuple[str, ...] = ("1f1b", "bpipe",
                              "1f1b_interleaved", "bpipe_interleaved")
    attentions: Tuple[str, ...] = ATTENTION_ARMS
    vs: Tuple[int, ...] = (2, 4)
    # Offsets from the schedule's default cap. 0 first so ties between
    # equivalent caps resolve to the paper's bound; +k trades evictor
    # memory for less eviction traffic, -k the reverse.
    cap_deltas: Tuple[int, ...] = (0, 1, -1)
    max_b: int = 0          # 0 = up to B
    # Residency policies paired with each UNBALANCED kind (balanced
    # kinds embed bpipe_swap). "none" keeps the un-managed baseline in
    # the table.
    residencies: Tuple[str, ...] = ("none", "host_offload",
                                    "selective_recompute")
    # Transfer-overlap depths searched for residency-managed plans
    # (depth 1 = the serialized classic, listed first so ties between
    # equal-makespan depths resolve to the cheapest memory profile).
    depths: Tuple[int, ...] = (1, 2)
    # Sequence slices per microbatch (SlimPipe direction,
    # docs/longcontext.md). Opt-in: the default searches only the
    # unsliced classic so the paper-condition verdicts (Table 3) are
    # untouched; long-context sweeps pass e.g. (1, 2, 4). c > 1 applies
    # only to kinds with a sliced builder (``ScheduleKind.sliced``) and
    # to sequence lengths c divides; 1 first so ties resolve unsliced.
    seq_chunkses: Tuple[int, ...] = (1,)
    # Vocabulary-parallel degrees (docs/memory.md "Vocab accounting"):
    # vp > 1 scatters the embedding/head/logits spike over vp boundary
    # stages for per-microbatch collective traffic. Opt-in like
    # seq_chunkses — the default searches only the unscattered classic
    # so the paper-condition verdicts (Table 3) are untouched; large-
    # vocab sweeps pass e.g. (1, 2, 4). vp is clamped to vp <= p at
    # enumeration; 1 first so ties resolve unscattered.
    vocab_parallels: Tuple[int, ...] = (1,)


def micro_batch_sizes(B: int, max_b: int = 0) -> List[int]:
    """Power-of-two micro batch sizes dividing B (the paper's ladder)."""
    out, b = [], 1
    while b <= B and (not max_b or b <= max_b):
        if B % b == 0:
            out.append(b)
        b *= 2
    return out


def _cap_ladder(default: int, roof: int,
                deltas: Tuple[int, ...]) -> List[Optional[int]]:
    """Planner cap offsets around a default bound, clamped to [2, roof]
    (at/above the roof the rewrite degenerates to the unmanaged twin)."""
    caps: List[Optional[int]] = []
    seen = set()
    for d in deltas:
        cap = min(max(default + d, 2), roof)
        if cap in seen:
            continue
        seen.add(cap)
        caps.append(None if cap == default else cap)
    return caps


def _caps_for(kind: str, p: int, v: int, deltas: Tuple[int, ...],
              m: int, seq_chunks: int = 1) -> List[Optional[int]]:
    # Anything at or above the plain-schedule peak never evicts — the
    # candidate degenerates to its non-BPipe twin, so clamp at the
    # kind's registered roof (stage-0 peak closed forms; see the
    # ``ScheduleKind.cap_roof`` entries in core/schedule.py). Sliced
    # schedules count slice units: default and roof both widen by the
    # extra warmup slices so the delta ladder stays centered.
    extra = seq_chunks - 1
    return _cap_ladder(sched.schedule_cap(kind, p, v,
                                          seq_chunks=seq_chunks),
                       sched.SCHEDULES[kind].cap_roof(p, m, v) + extra,
                       deltas)


def _residency_caps(pol: "respol.ResidencyPolicy", p: int, v: int,
                    deltas: Tuple[int, ...], m: int,
                    seq_chunks: int = 1) -> List[Optional[int]]:
    extra = seq_chunks - 1
    return _cap_ladder(pol.default_cap(p, v) + extra,
                       pol.cap_roof(p, m, v) + extra, deltas)


def enumerate_candidates(n: Notation, space: SearchSpace = SearchSpace(),
                         num_layers: int = 0) -> Iterator[Candidate]:
    """Yield every structurally valid candidate for Notation ``n``
    (attention arms x kinds x residencies x b x v x cap). ``num_layers``
    (0 = skip the check) bounds p*v for interleaved kinds."""
    p = n.p
    # vocab-parallel degrees scatter over pipeline stages, so vp > p is
    # structurally meaningless (the spec would reject it)
    vps = [vp for vp in space.vocab_parallels if 1 <= vp <= p] or [1]
    for attention in space.attentions:
        for b in micro_batch_sizes(n.B, space.max_b):
            m = n.B // b
            for kind in space.kinds:
                assert kind in sched.SCHEDULES, kind
                entry = sched.SCHEDULES[kind]
                vs = space.vs if entry.interleaved else (1,)
                for v in vs:
                    if entry.interleaved:
                        if v < 2 or m % p != 0:
                            continue
                        if num_layers and p * v > num_layers:
                            continue
                    elif num_layers and p > num_layers:
                        continue
                    # sequence slicing (seq_chunks > 1) applies only to
                    # kinds with a sliced builder and to sequence
                    # lengths the chunk count divides
                    chunkses = [c for c in space.seq_chunkses
                                if c == 1 or (entry.sliced
                                              and n.s % c == 0)]
                    for c, vp in ((c, vp) for c in chunkses for vp in vps):
                        if entry.balanced:
                            # balanced kinds ARE the swap policy; the cap
                            # ladder is theirs, and each cap opens the
                            # overlap-depth ladder
                            for cap in _caps_for(kind, p, v,
                                                 space.cap_deltas, m, c):
                                for depth in space.depths:
                                    yield Candidate(kind=kind, b=b, m=m,
                                                    v=v, cap=cap,
                                                    attention=attention,
                                                    residency="bpipe_swap",
                                                    depth=depth,
                                                    seq_chunks=c,
                                                    vocab_parallel=vp)
                            continue
                        for residency in space.residencies:
                            pol = respol.POLICIES.get(residency)
                            assert pol is not None and not pol.swap, \
                                residency
                            caps = (_residency_caps(pol, p, v,
                                                    space.cap_deltas, m, c)
                                    if pol.active else [None])
                            # depth only matters when bytes move on a
                            # channel
                            depths = (space.depths if pol.moves_data
                                      else (1,))
                            for cap in caps:
                                for depth in depths:
                                    yield Candidate(kind=kind, b=b, m=m,
                                                    v=v, cap=cap,
                                                    attention=attention,
                                                    residency=residency,
                                                    depth=depth,
                                                    seq_chunks=c,
                                                    vocab_parallel=vp)
