"""Transfer channels: the directional links residency moves ride.

A channel is one serialized link endpoint:

  * ``(PEER, a, b)`` — the evictor<->acceptor pair link (NVLink / 1-hop
    ICI). EVICT and LOAD of a pair share it in both directions — the
    paper's §4 overlap argument is about exactly this link keeping up
    with two moves per F+B slot, which is why it is modeled
    half-duplex-shared (the pinned ``(Tf+Tb)/(2v)`` stall threshold
    falls out of that sharing).
  * ``(D2H, i)`` / ``(H2D, i)`` — the two directions of device ``i``'s
    host link (PCIe-class). Direction-split: offload traffic does not
    contend with fetch traffic.

``Channel`` is the pricing model the simulator uses: transfers are
serialized FIFO in issue order, each occupying the link for its
transfer time; occupancy statistics (how many transfers were in flight
— issued but not complete — at once) report how much overlap a schedule
actually achieved. ``channel_key`` is shared with the executor's
``runtime`` so both sides agree on what contends with what.

Recompute-mechanism policies have no channel (their restore bill is
FLOPs on the compute frontier, not bytes on a link): ``channel_key``
returns ``None`` for them.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

#: Channel kinds. PEER is the evictor<->acceptor pair link; D2H/H2D are
#: the two directions of a device's host link.
PEER, D2H, H2D = "peer", "d2h", "h2d"

ChannelKey = Tuple


def channel_key(mechanism: str, stage: int, partner: Optional[int] = None,
                release: bool = True) -> Optional[ChannelKey]:
    """The channel a residency move of ``mechanism`` issued by ``stage``
    rides: the shared pair link for the swap, the release (D2H) or
    restore (H2D) half of the host link for offload, ``None`` when the
    mechanism moves no bytes (recompute, none)."""
    if mechanism == "swap":
        assert partner is not None, stage
        return (PEER, min(stage, partner), max(stage, partner))
    if mechanism == "host":
        return (D2H if release else H2D, stage)
    return None


@dataclasses.dataclass
class ChannelStats:
    """Occupancy accounting for one channel over a simulated step."""
    key: ChannelKey
    moves: int = 0           # transfers issued
    busy: float = 0.0        # summed transfer (link-occupancy) time
    queue_peak: int = 0      # max transfers in flight at one instant
    stall: float = 0.0       # summed data-ready-but-link-busy wait

    def utilization(self, makespan: float) -> float:
        return self.busy / makespan if makespan > 0 else 0.0


class Channel:
    """One serialized link: FIFO transfer pricing plus in-flight
    occupancy tracking.

    ``issue(ready)`` prices one transfer whose input data is available
    at time ``ready``: it starts when both the data and the link are
    ready and occupies the link for ``t_move``. Transfers are processed
    in issue order (each stage issues its own moves in stream order, so
    for single-issuer channels — every built-in policy at default caps —
    the FIFO order is deterministic regardless of engine dispatch
    order).

    ``depth`` is the bounded-admission half of the issue-early
    contract: transfer k may not be *issued* (its source buffer pinned)
    before the (k - depth)-th prior transfer completed — the same cap
    the executor's ``AsyncTransferRuntime`` enforces on real copies and
    ``memory_model`` charges, so ``queue_peak`` (in-flight transfers,
    issue to completion) never exceeds ``depth``. Because the link
    itself serializes, the admission delay provably cannot change
    start/end times: ``start = max(ready, free)`` and ``free`` is the
    last completion, which is >= every earlier one — deeper overlap is
    therefore priced purely through the issue-early window the
    simulator widens by ``spec.depth`` slots before calling ``issue``.
    """

    def __init__(self, key: ChannelKey, t_move: float, depth: int = 1):
        assert depth >= 1, depth
        self.key = key
        self.t_move = float(t_move)
        self.depth = depth
        self.free = 0.0
        self._ends: List[float] = []          # completion times, ascending
        self.stats = ChannelStats(key)

    def issue(self, ready: float) -> Tuple[float, float]:
        """Price one transfer: returns ``(start, end)``."""
        data_ready = ready
        # bounded admission: wait for a free in-flight slot (no effect
        # on start/end — see the class docstring — only on occupancy)
        if len(self._ends) >= self.depth:
            ready = max(ready, self._ends[-self.depth])
        start = max(ready, self.free)
        end = start + self.t_move
        # in flight at issue time: this transfer plus every earlier one
        # not yet complete when this one was admitted. _ends is
        # ascending (each end >= the previous channel-free time), so the
        # count is a bisect, not a scan — the planner prices O(m) moves
        # per channel per candidate.
        pending = len(self._ends) - bisect.bisect_right(self._ends,
                                                        ready) + 1
        self._ends.append(end)
        st = self.stats
        st.moves += 1
        st.busy += self.t_move
        st.stall += start - data_ready
        st.queue_peak = max(st.queue_peak, pending)
        self.free = end
        return start, end
