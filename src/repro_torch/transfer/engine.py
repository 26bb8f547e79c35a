"""``TransferEngine``: the simulator-facing channel set for one compiled
schedule.

Built per simulated step from a ``plan.Schedule`` plus per-channel-kind
transfer times, it maps every registered residency policy's moves onto
channels by mechanism (swap -> the pair link, host -> the D2H/H2D
halves; recompute -> no channel) and prices them through the serialized
FIFO model in ``repro_torch.transfer.channel``. The simulator's handlers stop
owning link bookkeeping: they ask the engine to issue and read back
``(start, end)``.

A policy registered by a plugin (``repro_torch.memory.policy.register``) is
routed here with no engine edits — the mechanism field is the whole
contract.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.memory.policy import ResidencyPolicy
from repro_torch.transfer.channel import (D2H, H2D, PEER, Channel, ChannelKey,
                                    ChannelStats, channel_key)


class TransferEngine:
    """Per-device directional channels for one compiled ``Schedule``.

    ``depth`` is the bounded-admission cap every channel applies (see
    ``channel.Channel`` — it bounds occupancy, provably not completion
    times); the matching issue-early *window* is the simulator's knob
    (it widens the restore issue time by ``spec.depth`` slots before
    calling ``issue``), and the executor runtime enforces the same cap
    on real copies."""

    def __init__(self, schedule, *, t_peer: float = 0.0, t_d2h: float = 0.0,
                 t_h2d: float = 0.0, depth: int = 1, observer=None):
        self.schedule = schedule
        self.depth = max(1, int(depth))
        self._t = {PEER: t_peer, D2H: t_d2h, H2D: t_h2d}
        self.channels: Dict[ChannelKey, Channel] = {}
        # duck-typed repro_torch.obs Observer: every priced move additionally
        # emits a channel-track span (enqueue -> dequeue) when attached
        self.observer = observer

    def key_for(self, pol: ResidencyPolicy, stage: int,
                release: bool) -> Optional[ChannelKey]:
        return channel_key(pol.mechanism, stage,
                           self.schedule.partner.get(stage), release)

    def channel_for(self, pol: ResidencyPolicy, stage: int,
                    release: bool) -> Optional[Channel]:
        key = self.key_for(pol, stage, release)
        if key is None:
            return None
        ch = self.channels.get(key)
        if ch is None:
            ch = self.channels[key] = Channel(key, self._t[key[0]],
                                              self.depth)
        return ch

    def issue(self, pol: ResidencyPolicy, stage: int, ready: float,
              release: bool, ins=None) -> Tuple[float, float]:
        """Issue one move on the policy's channel; returns ``(start,
        end)``. A channel-less mechanism (recompute's DROP) completes
        instantly at ``ready`` — its restore bill is the caller's.
        ``ins`` (the issuing ``PlannedInstr``) lets an attached observer
        label the channel-occupancy span it emits per move."""
        ch = self.channel_for(pol, stage, release)
        if ch is None:
            return ready, ready
        start, end = ch.issue(ready)
        if self.observer is not None and ins is not None:
            self.observer.emit(ins.op, stage, ins.mb, ins.chunk, ins.sl,
                               ins.phase, start, end, track="channel",
                               channel=ch.key)
        return start, end

    def stats(self) -> Dict[ChannelKey, ChannelStats]:
        return {key: ch.stats for key, ch in self.channels.items()}

    @property
    def queue_peak(self) -> int:
        """Max in-flight transfers reached on any channel."""
        return max((ch.stats.queue_peak for ch in self.channels.values()),
                   default=0)
