"""``bench/ranges.py``: the interval arithmetic that splits the device's idle
time by the program's ranges, on synthetic gaps and ranges, and the four
readers built on it, on a stand-in trace and on a tiny traced run on the
CPU."""
import random
import types

import pytest

from bench import ranges, run, spec

NEW = ("idle_fwd_pct", "idle_bwd_pct", "idle_interp_pct", "cast_gradsum_pct")


def _random_intervals(rng, n, lo=0.0, hi=100.0):
    out = []
    for _ in range(n):
        a = rng.uniform(lo, hi)
        out.append((a, min(hi, a + rng.uniform(0.0, 15.0))))
    return ranges.merge(out)


def _covered(x, t):
    return any(a <= t < b for a, b in x)


def test_interval_operations_by_hand():
    x = [(0.0, 4.0), (6.0, 10.0)]
    y = [(2.0, 7.0), (9.0, 12.0)]
    assert ranges.merge([(6.0, 10.0), (0.0, 4.0), (3.0, 5.0), (1.0, 1.0)]) == \
        [(0.0, 5.0), (6.0, 10.0)]
    assert ranges.intersect(x, y) == [(2.0, 4.0), (6.0, 7.0), (9.0, 10.0)]
    assert ranges.subtract(x, y) == [(0.0, 2.0), (7.0, 9.0)]
    assert ranges.subtract(y, x) == [(4.0, 6.0), (10.0, 12.0)]
    assert ranges.length(x) == 8.0


@pytest.mark.parametrize("seed", range(8))
def test_the_split_partitions_the_idle_time(seed):
    rng = random.Random(seed)
    gaps = _random_intervals(rng, 30)
    step = _random_intervals(rng, 3, 5.0, 95.0)
    fwd = ranges.intersect(_random_intervals(rng, 12), step)
    bwd = ranges.intersect(_random_intervals(rng, 12), step)
    got = ranges.split_idle(gaps, step, fwd, bwd)
    parts = got["fwd"] + got["bwd"] + got["interp"] + got["outside"]
    assert parts == pytest.approx(got["idle"], abs=1e-9)
    assert got["idle"] == pytest.approx(ranges.length(gaps))
    # each part by sampling: a point of a gap falls into exactly one part
    grid = [i / 10.0 for i in range(1000)]
    count = dict.fromkeys(("fwd", "bwd", "interp", "outside"), 0)
    for t in grid:
        if not _covered(gaps, t):
            continue
        if not _covered(step, t):
            count["outside"] += 1
        elif _covered(fwd, t):
            count["fwd"] += 1
        elif _covered(bwd, t):
            count["bwd"] += 1
        else:
            count["interp"] += 1
    for k, n in count.items():
        assert got[k] == pytest.approx(n / 10.0, abs=1.5 + 0.05 * got[k]), k


def _event(name, a, b, device_us=0.0):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                 device_time_total=device_us)


class _Trace:
    """What the readers use of ``bench.trace.Trace``: a window of 100 us,
    the device busy in [10, 30) and [60, 70)."""
    w0, w1 = 0.0, 100.0
    window_s, busy_s = 1e-4, 3e-5

    def __init__(self, host):
        self.host = host

    def gaps(self):
        return [(0.0, 10.0), (30.0, 60.0), (70.0, 100.0)]


def _read(name, trace):
    return spec.metric_reader(name)(run.Ctx(model={}, traffic={}, module=None, trace=trace,
                                            stats=None, tokens=0))


def test_readers_on_a_stand_in_trace():
    trace = _Trace([_event("pipe.step", 5.0, 95.0), _event("pipe.F", 25.0, 40.0),
                    _event("pipe.B", 50.0, 80.0), _event("pipe.grad_sum", 78.0, 80.0, 4.0),
                    _event("cast", 26.0, 27.0, 3.0), _event("aten::mm", 26.0, 27.0, 9.0)])
    # idle: [5, 10) interp, [30, 40) fwd, [40, 50) interp, [50, 60) and [70, 80) bwd,
    # [80, 95) interp, [0, 5) and [95, 100) outside the step
    assert _read("idle_fwd_pct", trace) == pytest.approx(10.0)
    assert _read("idle_bwd_pct", trace) == pytest.approx(20.0)
    assert _read("idle_interp_pct", trace) == pytest.approx(30.0)
    assert ranges.idle_split(trace)["outside"] == pytest.approx(10.0)
    us = ranges.idle_us(trace)
    assert (us["steps"], us["fwd"], us["bwd"], us["interp"]) == (1, 10.0, 20.0, 30.0)
    # a share of the 30 us the device was busy, not of the window
    assert _read("cast_gradsum_pct", trace) == pytest.approx(100.0 * 7e-6 / 3e-5)


def test_readers_return_none_without_the_programs_ranges():
    trace = _Trace([_event("aten::mm", 26.0, 27.0, 9.0), _event("moe_dispatch", 1.0, 2.0)])
    assert all(_read(name, trace) is None for name in NEW)


def test_a_tiny_traced_run_reports_the_split(tiny):
    out = run.run_cell(tiny("granite-moe.bpipe.b4"), 5, 0.1, True, "cpu",
                       log=lambda msg: None)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    for name in ("idle_fwd_pct", "idle_bwd_pct", "idle_interp_pct"):
        assert 0.0 <= got[name] <= 100.0, name
    assert got["idle_fwd_pct"] > 0 and got["idle_bwd_pct"] > 0
    # no device: the window is all idle, and the step's parts stay under it
    assert got["device_idle_pct"] == pytest.approx(100.0)
    assert got["idle_fwd_pct"] + got["idle_bwd_pct"] + got["idle_interp_pct"] <= 100.0 + 1e-9
    assert "cast_gradsum_pct" not in got  # no device time on the CPU
