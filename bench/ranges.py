"""The program's own profiler ranges on a traced window (``bench/trace.py``'s
``Trace``): the device's idle time split by what the executor was doing,
and the device time of the kernels launched under named ranges.

The executor (``repro_torch.pipeline.executor``) opens ``pipe.step`` around
each step and ``pipe.<OP>`` around each instruction it retires, all on the
main thread; ``layers.cast_matmul`` / ``cast_bmm`` open ``cast`` around
each weight cast, forward and backward; the executor opens ``pipe.grad_sum``
around its fp32 grad sums. A program without them yields no intervals,
and the readers built on this return None.

The idle intervals (``Trace.gaps()``) inside ``pipe.step`` fall into three
parts: under ``pipe.F`` or ``pipe.RECOMPUTE`` (``FWD``), under ``pipe.B``
(``BWD``), and the rest of the step (the interpreter: the ready loop, the
store and its moves, the split, the merge and the loss). With the idle time
outside any step (the benchmark's synchronise and its pick of a batch) the
four add up to the window's idle time.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from bench.trace import _merge as merge

Intervals = List[Tuple[float, float]]

STEP = "pipe.step"
FWD = ("pipe.F", "pipe.RECOMPUTE")
BWD = ("pipe.B",)
CAST_GRADSUM = ("cast", "pipe.grad_sum")


def intersect(x: Intervals, y: Intervals) -> Intervals:
    """Where two merged interval lists overlap."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Intervals, y: Intervals) -> Intervals:
    """``x`` less ``y``, both merged."""
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if b > a:
            out.append((a, b))
    return out


def length(x: Intervals) -> float:
    return sum(b - a for a, b in x)


def intervals(trace, names: Sequence[str]) -> Intervals:
    """The host ranges named ``names``, merged, clipped to the window."""
    return merge((max(e.time_range.start, trace.w0), min(e.time_range.end, trace.w1))
                 for e in trace.host if e.name in names)


def split_idle(gaps: Intervals, step: Intervals, fwd: Intervals,
               bwd: Intervals) -> Dict[str, float]:
    """The idle intervals ``gaps`` in four disjoint parts, in the gaps' unit:
    under ``fwd``, under ``bwd`` (less ``fwd``), in ``step`` outside both
    (``interp``), and outside ``step`` (``outside``). All lists merged."""
    inside = intersect(gaps, step)
    f = intersect(inside, fwd)
    rest = subtract(inside, fwd)
    b = intersect(rest, bwd)
    return {"fwd": length(f), "bwd": length(b), "interp": length(subtract(rest, bwd)),
            "outside": length(subtract(gaps, step)), "idle": length(gaps)}


def idle_us(trace) -> Optional[Dict[str, float]]:
    """``split_idle`` of ``trace``'s device gaps in us, with ``steps``, the
    number of ``pipe.step`` ranges in the window; None where the trace
    holds no ``pipe.step`` range or no window."""
    step = intervals(trace, (STEP,))
    if not step or trace.w1 <= trace.w0:
        return None
    parts = split_idle(merge(trace.gaps()), step, intervals(trace, FWD),
                       intervals(trace, BWD))
    parts["steps"] = sum(e.name == STEP for e in trace.host)
    return parts


def idle_split(trace) -> Optional[Dict[str, float]]:
    """``idle_us`` in % of the traced window, less ``steps``."""
    parts = idle_us(trace)
    if parts is None:
        return None
    return {k: 100.0 * v / (trace.w1 - trace.w0) for k, v in parts.items()
            if k != "steps"}


def device_s(trace, names: Sequence[str]) -> float:
    """Device seconds of the kernels launched under the host ranges named
    ``names`` (none of which nests in another)."""
    return sum(e.device_time_total for e in trace.host if e.name in names) / 1e6
