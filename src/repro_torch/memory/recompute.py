"""``selective_recompute`` residency: free the saved tensors, re-forward.

The paper's recompute arms treat recomputation as an *attention* knob
baked into the cost model; this policy makes it a schedulable residency
mechanism instead: DROP frees a held unit's saved tensors (keeping only
the boundary input activation it arrived with — ``retained_bytes`` =
2sbh/t), and RECOMPUTE re-runs that (virtual) stage's forward from the
retained input just before the backward, rebuilding the residuals the
backward consumes. No bytes move (``moves_data`` is False); the cost is
FLOPs — the simulator charges one chunk-level forward (Tf/v) per
RECOMPUTE on the stage's compute frontier, and the executor really
re-runs the stage forward so loss/grads stay bit-identical to the un-dropped
execution (the forward is deterministic).

Selection is the same cap-driven spill as BPipe's balancing: the unit
whose backward is farthest away is dropped first, bounded by the same
default cap — so bpipe_swap / host_offload / selective_recompute differ
*only* in mechanism, which is what makes the planner's three-way contest
(paper Table 3) a fair one.
"""
from __future__ import annotations

from repro_torch.core.notation import Notation
from repro_torch.core.schedule import DROP, RECOMPUTE
from repro_torch.memory import policy as respol


def boundary_bytes(n: Notation, attention: str, v: int) -> float:
    """Device bytes a dropped unit retains: the stage's boundary input
    activation (2sbh/t — the tensor the re-forward starts from)."""
    return 2.0 * n.s * n.b * n.h / n.t


SELECTIVE_RECOMPUTE = respol.register(respol.ResidencyPolicy(
    "selective_recompute", DROP, RECOMPUTE, mechanism="recompute",
    default_cap=respol.residency_cap,
    cap_roof=respol.residency_cap_roof,
    retained_bytes=boundary_bytes))
