"""BPipe planning: evictor/acceptor pairing, eviction counts, and the
pair-adjacent device layout (paper Fig. 2) adapted to the TPU ICI ring.

On GPUs the pair must share a node to ride NVLink; on a TPU ring/torus the
equivalent constraint is *hop distance 1* on the stage mesh axis. The
interleaved layout [0, p-1, 1, p-2, ...] puts every (x, p-1-x) pair on
neighbouring devices, so each eviction is a single collective_permute hop.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import plan as P
from repro_torch.core.schedule import bpipe_pairs


@dataclasses.dataclass(frozen=True)
class BPipePlan:
    p: int
    m: int                       # microbatches
    cap: int
    pairs: Tuple[Tuple[int, int], ...]
    evictions: Tuple[int, ...]   # per-stage eviction count
    stage_to_device: Tuple[int, ...]

    @property
    def partner(self) -> Dict[int, int]:
        d = {}
        for a, b in self.pairs:
            d[a] = b
            d[b] = a
        return d


def pair_adjacent_layout(p: int) -> List[int]:
    """stage -> device index such that every (x, p-1-x) pair is adjacent.

    [0, p-1, 1, p-2, ...]: device 2k hosts stage k, device 2k+1 hosts
    stage p-1-k. For GPU nodes of size >=2 pairs share a node (Fig. 2);
    on a TPU ring they are 1 ICI hop apart.
    """
    layout = [0] * p
    for k in range(p // 2):
        layout[k] = 2 * k
        layout[p - 1 - k] = 2 * k + 1
    if p % 2:
        layout[p // 2] = p - 1
    return layout


def plan(p: int, m: int,
         stage_to_device: Optional[Tuple[int, ...]] = None,
         spec: Optional[P.ScheduleSpec] = None) -> BPipePlan:
    """BPipe plan for p stages / m microbatches. ``stage_to_device``
    overrides the pair-adjacent default — e.g. when the stages are laid
    onto a mesh axis larger than p. ``spec`` selects the exact balanced
    variant (interleaved kind, cap override) so the eviction counts match
    the stream actually built; default is plain BPipe at the paper cap."""
    spec = spec or P.ScheduleSpec("bpipe", p, m)
    assert spec.balanced and (spec.p, spec.m) == (p, m), spec
    compiled = P.compile_plan(spec)
    return BPipePlan(
        p=p, m=m, cap=spec.resolved_cap,
        pairs=tuple(bpipe_pairs(p)),
        evictions=tuple(compiled.num_evictions[i] for i in range(p)),
        stage_to_device=(tuple(stage_to_device) if stage_to_device is not None
                         else tuple(pair_adjacent_layout(p))),
    )


def ring_extent(plan_: BPipePlan) -> int:
    """Size of the device ring the layout maps onto: the extent of
    ``stage_to_device``, NOT p — the mesh axis can be larger than the
    stage count (e.g. 4 stages spread over an 8-device ring)."""
    return max(plan_.stage_to_device) + 1


def hop_distance(plan_: BPipePlan, ring_size: Optional[int] = None) -> Dict[Tuple[int, int], int]:
    """ICI ring hop distance between each evictor/acceptor pair.

    The wraparound arm is measured on the *device* ring (``ring_extent``),
    not on p: with p stages laid onto a larger mesh axis, a p-sized ring
    under- (or negatively!) counted the wrap distance."""
    n = ring_size or ring_extent(plan_)
    out = {}
    for a, b in plan_.pairs:
        da, db = plan_.stage_to_device[a], plan_.stage_to_device[b]
        d = abs(da - db)
        out[(a, b)] = min(d, n - d)
    return out


def node_of(device: int, node_size: int) -> int:
    return device // node_size


def pairs_within_node(plan_: BPipePlan, node_size: int) -> bool:
    """Paper Fig. 2 property: every pair lives on one node (GPU view)."""
    return all(
        node_of(plan_.stage_to_device[a], node_size)
        == node_of(plan_.stage_to_device[b], node_size)
        for a, b in plan_.pairs)
