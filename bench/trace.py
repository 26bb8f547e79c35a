"""What a ``torch.profiler`` trace of the window says: the device's busy
time, its idle gaps and what the host was doing in them, each kernel's
time, and the device time under the program's ``record_function`` ranges.

Frozen from ``chip_smoke.py``'s ``profile_window`` and
``backward_of_range_us``: a range's device time is the device time of the
kernels launched inside it (host-side events, summed over the window) plus
that of its backward, either a named autograd node (the larger of its
"autograd::engine::evaluate_function: X" wrapper and "X", as one nests the
other) or, for a range without a node of its own, the backward nodes of
the autograd ops inside it, matched by sequence number.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

WINDOW_RANGE = "bench.window"
BACKWARD_NODE = "autograd::engine::evaluate_function: "
TOP = 10


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """A profiled window. Times in microseconds on the profiler's clock,
    which host and device events share."""

    def __init__(self, prof):
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        self.events = prof.events()
        host = [e for e in self.events if e.device_type == cpu]
        annotations = {e.name for e in host if getattr(e, "is_user_annotation", False)}
        annotations.add(WINDOW_RANGE)
        windows = [e for e in host if e.name == WINDOW_RANGE]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW_RANGE}' ranges")
        self.w0, self.w1 = windows[0].time_range.start, windows[0].time_range.end
        self.host = [e for e in host if e.name != WINDOW_RANGE]
        self.annotations = annotations
        # device operations: kernels, copies and fills, not the ranges'
        # device-side annotations
        self.ops = [(e.name, max(e.time_range.start, self.w0), min(e.time_range.end, self.w1))
                    for e in self.events
                    if e.device_type == cuda and e.name not in annotations
                    and not getattr(e, "is_user_annotation", False)]
        self.ops = [(n, a, b) for n, a, b in self.ops if b > a]
        self.busy = _merge([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def op_totals(self) -> Dict[str, Tuple[int, float]]:
        """{device op name: (count, seconds)}."""
        out: Dict[str, Tuple[int, float]] = {}
        for n, a, b in self.ops:
            c, s = out.get(n, (0, 0.0))
            out[n] = (c + 1, s + (b - a) / 1e6)
        return out

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle intervals of the device inside the window."""
        edges = [self.w0] + [t for ab in self.busy for t in ab] + [self.w1]
        return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the program's ranges open then,
        outermost first, and the innermost event."""
        covering = [e for e in self.host if e.time_range.start <= t < e.time_range.end]
        if not covering:
            return "host outside any recorded op"
        covering.sort(key=lambda e: -(e.time_range.end - e.time_range.start))
        names = [e.name for e in covering if e.name in self.annotations]
        inner = covering[-1].name
        if not names or names[-1] != inner:
            names.append(inner)
        return " > ".join(names)

    def range_s(self, name: str, backward: Optional[str]) -> float:
        """Device seconds under the host range ``name``, its backward
        charged as the module docstring says; 0 where the range is absent."""
        fwd = sum(e.device_time_total for e in self.host if e.name == name)
        if backward is None:
            bwd = self._backward_of_range(name)
        else:
            bwd = max(sum(e.device_time_total for e in self.host if e.name == k)
                      for k in (backward, BACKWARD_NODE + backward))
        return (fwd + bwd) / 1e6

    def _backward_of_range(self, name: str) -> float:
        seqs, stack = set(), [e for e in self.host if e.name == name]
        while stack:
            e = stack.pop()
            stack.extend(e.cpu_children)
            if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
                seqs.add(e.sequence_nr)
        return sum(e.device_time_total for e in self.host
                   if e.name.startswith(BACKWARD_NODE) and e.sequence_nr in seqs)

    def breakdown(self) -> Dict[str, List[List]]:
        """The device ops that took most time and the longest idle gaps,
        labelled by what the host was doing, at most ``TOP`` of each."""
        ops = sorted(self.op_totals().items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps(), key=lambda ab: -(ab[1] - ab[0]))[:TOP]
        return {"device_ops": [[n[:160], s] for n, (_, s) in ops],
                "idle_gaps": [[self.host_at((a + b) / 2)[:160], (b - a) / 1e6]
                              for a, b in gaps]}
