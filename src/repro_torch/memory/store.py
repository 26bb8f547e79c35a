"""The activation store: per-device stash of autograd graphs with
residency-aware slots and byte accounting (re-homed from
``pipeline.executor.ActivationStore``).

Four slot classes per device:
  local[i]    the device's own live residuals, keyed (mb, chunk, sl)
  foreign[i]  units accepted from the paired BPipe evictor,
              keyed (owner_stage, mb, chunk, sl)
  host[i]     units offloaded to host memory (device bytes: zero)
  dropped[i]  units whose residuals were freed; only the retained
              boundary input remains (device bytes: ``retained_bytes``)

``sl`` is the sequence slice (``ScheduleSpec.seq_chunks`` > 1 — 0 for
unsliced schedules): a sliced unit is a first-class stash like any
other, so every residency policy manages sliced KV with zero new
mechanism. ``peek`` reads a unit's payload WHEREVER it lives — a later
slice's forward must reach the retained-KV prefix even after a policy
released the unit (docs/longcontext.md).

Byte accounting uses a per-(owner_stage, chunk) weight — the same
v-chunk weighting ``core.memory_model.act_bytes_per_stage`` charges
(each interleaved unit holds 1/v of the device's layers) — so
executor-reported ``peak_bytes``/``bytes_moved`` agree with the memory
model's per-stage numbers instead of a single flat per-unit float.
``peak_local`` counts device-resident *full* units (local + foreign),
which is what the compiled plan's cap/bounds are asserted against;
``peak_bytes`` additionally carries the dropped units' retained bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple, Union

Unit = Tuple[int, int, int]  # (mb, chunk, sl) — one stash unit

#: Per-unit byte weight: a flat float, or ``(owner_stage, chunk) -> bytes``
#: for schedules whose units differ in size. Sliced schedules use a
#: uniform per-slice weight (``memory_model.sliced_unit_bytes``), so the
#: callable signature needs no slice argument.
UnitBytes = Union[float, Callable[[int, int], float]]


@dataclasses.dataclass
class StoreStats:
    peak_local: Dict[int, int]
    peak_bytes: Dict[int, float]
    evictions: int
    loads: int
    bytes_moved: float
    offloads: int = 0
    fetches: int = 0
    drops: int = 0
    recomputes: int = 0
    host_peak_bytes: Dict[int, float] = dataclasses.field(default_factory=dict)
    transfers_inflight_peak: int = 0   # max in-flight moves on one channel
    #                                    (executor transfer runtime; at most
    #                                    ScheduleSpec.depth — the slot is
    #                                    reserved before the copy starts)


class ActivationStore:
    """Residency-aware per-device stash with live peak accounting."""

    def __init__(self, p: int, unit_bytes: UnitBytes = 0.0,
                 retained_bytes: float = 0.0):
        self.p = p
        self._w = unit_bytes if callable(unit_bytes) \
            else (lambda stage, chunk, w=float(unit_bytes): w)
        self.retained_bytes = retained_bytes
        self.local: List[Dict[Unit, Any]] = [dict() for _ in range(p)]
        self.foreign: List[Dict[Tuple[int, int, int, int], Any]] = [
            dict() for _ in range(p)]
        self.host: List[Dict[Unit, Any]] = [dict() for _ in range(p)]
        self.dropped: List[Dict[Unit, Any]] = [dict() for _ in range(p)]
        self.peak: Dict[int, int] = {i: 0 for i in range(p)}
        self.cur_bytes: Dict[int, float] = {i: 0.0 for i in range(p)}
        self.peak_bytes: Dict[int, float] = {i: 0.0 for i in range(p)}
        self.host_bytes: Dict[int, float] = {i: 0.0 for i in range(p)}
        self.host_peak_bytes: Dict[int, float] = {i: 0.0 for i in range(p)}
        self.evictions = 0
        self.loads = 0
        self.offloads = 0
        self.fetches = 0
        self.drops = 0
        self.recomputes = 0
        self.bytes_moved = 0.0

    # -- accounting helpers ------------------------------------------------
    def unit_bytes(self, owner: int, chunk: int) -> float:
        return self._w(owner, chunk)

    def _bump(self, i: int) -> None:
        n = len(self.local[i]) + len(self.foreign[i])
        self.peak[i] = max(self.peak[i], n)
        self.peak_bytes[i] = max(self.peak_bytes[i], self.cur_bytes[i])

    def _add_bytes(self, i: int, delta: float) -> None:
        self.cur_bytes[i] += delta

    def held(self, i: int) -> int:
        """Device-resident full units (what the stash cap bounds)."""
        return len(self.local[i]) + len(self.foreign[i])

    def resident_bytes(self, i: int) -> float:
        """Current device-resident activation bytes on stage ``i`` — the
        live sample the executor attaches to each span (``Span.hbm``) so
        observed traces carry a real memory counter track."""
        return self.cur_bytes[i]

    # -- live residency ----------------------------------------------------
    def put(self, i: int, mb: int, stash: Any, chunk: int = 0,
            sl: int = 0) -> None:
        assert (mb, chunk, sl) not in self.local[i], (i, mb, chunk, sl)
        self.local[i][(mb, chunk, sl)] = stash
        self._add_bytes(i, self._w(i, chunk))
        self._bump(i)

    def pop(self, i: int, mb: int, chunk: int = 0, sl: int = 0) -> Any:
        stash = self.local[i].pop((mb, chunk, sl))
        self._add_bytes(i, -self._w(i, chunk))
        return stash

    def peek(self, i: int, mb: int, chunk: int = 0, sl: int = 0) -> Any:
        """Read a unit's payload wherever it currently lives — local,
        shipped to a partner, host-offloaded, or residual-dropped —
        without moving or re-accounting it. The sliced forward's
        retained-KV reads go through this, so no residency policy can
        deadlock a later slice by releasing an earlier one (reading a
        host/partner-resident array costs a transfer the runtime
        already overlaps; the bytes stay charged where the unit lives).
        """
        key = (mb, chunk, sl)
        ent = self.local[i].get(key)
        if ent is not None:
            return ent
        for j in range(self.p):
            ent = self.foreign[j].get((i, mb, chunk, sl))
            if ent is not None:
                return ent
        ent = self.host[i].get(key)
        if ent is not None:
            return ent
        return self.dropped[i][key]

    # -- bpipe_swap: partner store ----------------------------------------
    def evict(self, i: int, mb: int, partner: int, chunk: int = 0,
              sl: int = 0) -> Any:
        """Ship (mb, chunk, sl) to the paired acceptor; returns the moved
        stash (the in-flight payload the transfer runtime tracks)."""
        stash = self.local[i].pop((mb, chunk, sl))
        self.foreign[partner][(i, mb, chunk, sl)] = stash
        w = self._w(i, chunk)
        self.evictions += 1
        self.bytes_moved += w
        self._add_bytes(i, -w)
        self._add_bytes(partner, w)
        self._bump(partner)
        return stash

    def load(self, i: int, mb: int, partner: int, chunk: int = 0,
             sl: int = 0) -> Any:
        stash = self.foreign[partner].pop((i, mb, chunk, sl))
        self.local[i][(mb, chunk, sl)] = stash
        w = self._w(i, chunk)
        self.loads += 1
        self.bytes_moved += w
        self._add_bytes(partner, -w)
        self._add_bytes(i, w)
        self._bump(i)
        return stash

    # -- host_offload: D2H / H2D ------------------------------------------
    def offload(self, i: int, mb: int, chunk: int = 0, sl: int = 0,
                mover: Callable[[Any], Any] = lambda s: s) -> Any:
        stash = mover(self.local[i].pop((mb, chunk, sl)))
        self.host[i][(mb, chunk, sl)] = stash
        w = self._w(i, chunk)
        self.offloads += 1
        self.bytes_moved += w
        self._add_bytes(i, -w)
        self.host_bytes[i] += w
        self.host_peak_bytes[i] = max(self.host_peak_bytes[i],
                                      self.host_bytes[i])
        return stash

    def fetch(self, i: int, mb: int, chunk: int = 0, sl: int = 0,
              mover: Callable[[Any], Any] = lambda s: s) -> Any:
        stash = mover(self.host[i].pop((mb, chunk, sl)))
        self.local[i][(mb, chunk, sl)] = stash
        w = self._w(i, chunk)
        self.fetches += 1
        self.bytes_moved += w
        self.host_bytes[i] -= w
        self._add_bytes(i, w)
        self._bump(i)
        return stash

    # -- selective_recompute: free residuals, keep the boundary input ------
    def drop(self, i: int, mb: int, chunk: int = 0, sl: int = 0,
             strip: Callable[[Any], Any] = lambda entry: None) -> None:
        """Free (mb, chunk, sl)'s residuals, keeping only ``strip(entry)``
        (the boundary input the re-forward starts from — plus the slice's
        own KV under sequence slicing)."""
        entry = self.local[i].pop((mb, chunk, sl))
        self.dropped[i][(mb, chunk, sl)] = strip(entry)
        self.drops += 1
        self._add_bytes(i, -(self._w(i, chunk) - self.retained_bytes))

    def dropped_input(self, i: int, mb: int, chunk: int = 0,
                      sl: int = 0) -> Any:
        return self.dropped[i][(mb, chunk, sl)]

    def recompute(self, i: int, mb: int, stash: Any, chunk: int = 0,
                  sl: int = 0) -> None:
        """Re-install the residuals ``stash`` rebuilt by the re-forward."""
        del self.dropped[i][(mb, chunk, sl)]
        self.local[i][(mb, chunk, sl)] = stash
        self.recomputes += 1
        self._add_bytes(i, self._w(i, chunk) - self.retained_bytes)
        self._bump(i)

    def stats(self) -> StoreStats:
        return StoreStats(
            peak_local=dict(self.peak),
            peak_bytes=dict(self.peak_bytes),
            evictions=self.evictions, loads=self.loads,
            bytes_moved=self.bytes_moved,
            offloads=self.offloads, fetches=self.fetches,
            drops=self.drops, recomputes=self.recomputes,
            host_peak_bytes=dict(self.host_peak_bytes))
