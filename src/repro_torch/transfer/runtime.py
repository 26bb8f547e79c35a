"""``AsyncTransferRuntime``: the executor-facing half of the transfer
engine (the twin of the JAX package's ``repro/transfer/runtime.py``).

The executor's host copies are *async*: ``memory.offload`` issues them on
a side CUDA stream and records an event in the moved unit's box, so the
call returns before the copy completes. That is exactly the
issue-early/complete-lazy contract — but unbounded in-flight copies would
pin unbounded source buffers, so live memory bounds would only hold on
paper. This runtime tracks every in-flight move per channel (the same
``channel_key`` vocabulary the simulator prices) and enforces the spec's
overlap ``depth``: submitting a move while ``depth`` transfers are already
in flight on that channel blocks on the oldest (its CUDA event's
``synchronize()``) before admitting the new one.

The executor's WAIT halves call ``wait`` with the move's unit key; the
runtime retires FIFO up to and including that unit, so the dependent
compute touches the data only after the copy is really complete.
``drain()`` at step end retires everything (no copy escapes the step).
Store moves that copy nothing (EVICT/LOAD on one card) and every move on
the CPU carry no event, so retiring them does not block.
"""
from __future__ import annotations

import collections
from typing import Any, Deque, Dict, Hashable, Optional, Tuple

from repro_torch.transfer.channel import ChannelKey


def _block(payload: Any) -> Any:
    """Block until the copy that moved ``payload`` (a stash unit) is done:
    the CUDA event ``memory.offload`` recorded in its box, if it has one."""
    event = getattr(getattr(payload, "box", None), "event", None)
    if event is not None:
        event.synchronize()
    return payload


class AsyncTransferRuntime:
    """Bounded-depth in-flight tracking over real async copies.

    ``observer`` (the duck-typed ``repro_torch.obs`` contract) plus ``clock``
    (a zero-arg step-relative timer) turn every real move into a
    channel-track span — submit time to retire (block) time, the same
    occupancy interval the simulator's ``Channel`` prices — keyed by the
    move's unit key (``PlannedInstr.done_key``: (op, stage, mb, chunk,
    sl))."""

    def __init__(self, depth: int = 1, observer=None, clock=None):
        self.depth = max(1, int(depth))
        self._q: Dict[ChannelKey, Deque[Tuple[Hashable, Any, float]]] = {}
        self.submitted = 0
        self.retired = 0
        self.inflight_peak = 0       # max in-flight on any one channel
        self.observer = observer
        self.clock = clock if clock is not None else (lambda: 0.0)

    def submit(self, key: Optional[ChannelKey], unit: Hashable,
               launch: Any) -> Any:
        """Issue one move: reserve a channel slot, then call ``launch``
        (the thunk that starts the async copy — a store move wrapping
        ``memory.offload``'s mover) and track its payload. The slot is reserved
        *before* the copy starts — the oldest in-flight move is retired
        (blocked on) first — so at most ``depth`` copies are ever
        concurrently in flight per channel, exactly what
        ``memory_model`` budgets. ``key=None`` (channel-less
        mechanisms) just runs the thunk."""
        if key is None:
            return launch()
        q = self._q.setdefault(key, collections.deque())
        while len(q) >= self.depth:   # depth cap: reserve the slot first
            self._retire(key, q.popleft())
        payload = launch()
        q.append((unit, payload, self.clock()))
        self.submitted += 1
        self.inflight_peak = max(self.inflight_peak, len(q))
        return payload

    def wait(self, key: Optional[ChannelKey], unit: Hashable) -> None:
        """Complete-lazy barrier: block until ``unit``'s move (and every
        earlier move on the channel — FIFO) is done. A unit the depth
        cap already retired is a no-op — blocking on *newer* unrelated
        transfers would serialize exactly the overlap the depth knob
        buys."""
        if key is None:
            return
        q = self._q.get(key)
        if not q or not any(u == unit for u, _, _ in q):
            return
        while q:
            item = q.popleft()
            self._retire(key, item)
            if item[0] == unit:
                break

    def drain(self) -> None:
        """Retire every in-flight move (step barrier)."""
        for key, q in self._q.items():
            while q:
                self._retire(key, q.popleft())

    def _retire(self, key: ChannelKey,
                item: Tuple[Hashable, Any, float]) -> None:
        unit, payload, t_submit = item
        _block(payload)
        self.retired += 1
        if self.observer is not None:
            op, stage, mb, chunk, sl = unit
            self.observer.emit(op, stage, mb, chunk, sl, "",
                               t_submit, self.clock(), track="channel",
                               channel=key)
