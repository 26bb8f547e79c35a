"""``launches_step`` and ``syncs_step`` on a stand-in trace of two steps and
on a tiny traced run on the CPU."""
import types

import pytest

from bench import run, spec


def _event(name, a, b):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b))


class _Trace:
    """What the two readers use of ``bench.trace.Trace``: a window of 100 us
    holding two steps, [10, 45) and [50, 95), seven device operations and
    the host's runtime calls."""
    w0, w1 = 0.0, 100.0

    def __init__(self, host, ops=7):
        self.host = host
        self.ops = [("kernel", 10.0 + i, 10.5 + i) for i in range(ops)]


def _read(name, trace):
    return spec.metric_reader(name)(run.Ctx(model={}, traffic={}, module=None, trace=trace,
                                            stats=None, tokens=0))


STEPS = [_event("pipe.step", 10.0, 45.0), _event("pipe.step", 50.0, 95.0)]


def test_counts_a_step_on_a_stand_in_trace():
    host = STEPS + [
        _event("pipe.F", 12.0, 30.0),
        _event("cudaStreamSynchronize", 13.0, 14.0),   # inside step 1
        _event("cudaMemcpyAsync", 13.0, 13.5),         # no wait of its own
        _event("cudaLaunchKernel", 15.0, 15.2),
        _event("cudaMemcpy", 60.0, 61.0),              # inside step 2
        _event("cudaDeviceSynchronize", 70.0, 71.0),
        _event("cudaEventSynchronize", 94.0, 96.0),    # starts inside step 2
        _event("cudaStreamSynchronize", 47.0, 48.0),   # between the steps
        _event("cudaDeviceSynchronize", 96.0, 97.0),   # the benchmark's own
    ]
    trace = _Trace(host)
    assert _read("syncs_step", trace) == pytest.approx(4 / 2)
    assert _read("launches_step", trace) == pytest.approx(7 / 2)


def test_no_step_no_count():
    trace = _Trace([_event("cudaStreamSynchronize", 13.0, 14.0)])
    assert _read("syncs_step", trace) is None
    assert _read("launches_step", trace) is None


def test_a_tiny_traced_run_reports_the_counts(tiny):
    out = run.run_cell(tiny("granite-moe.bpipe.b4"), 5, 0.1, True, "cpu",
                       log=lambda msg: None)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # no device on the CPU: no operation, no runtime call
    assert got["launches_step"] == 0.0 and got["syncs_step"] == 0.0
