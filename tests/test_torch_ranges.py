"""The port's profiler ranges (``repro_torch.obs.ranges``) on the CPU,
through ``PipelineExecutor`` on a reduced granite-moe-1b-a400m: no range
is entered while no profiler records; under ``torch.profiler`` each
retired instruction has exactly one ``pipe.<OP>`` range, the model's and
the casts' ranges nest inside them, and every ``trace=True`` span, moved
by ``StepResult.t0_ns``, lies on its range."""
import collections
import functools
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import plan as P
from repro_torch.models import model as M
from repro_torch.obs import ranges
from repro_torch.pipeline import executor as X

LAYERS, MICRO, SEQ = 4, 4, 8
SPECS = {"1f1b": ("1f1b", "none"), "bpipe": ("bpipe", "bpipe_swap"),
         "host_offload": ("1f1b", "host_offload"),
         "selective_recompute": ("1f1b", "selective_recompute")}
MS = 1e6  # ns


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("granite-moe-1b-a400m").reduced(num_layers=LAYERS)
    gen = torch.Generator().manual_seed(0)
    params = M.init_params(gen, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (MICRO, SEQ + 1), generator=gen)
    return cfg, params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _spec(name):
    kind, residency = SPECS[name]
    return P.ScheduleSpec(kind, 4, MICRO, residency=residency)


def _profiled_step(name, trace=False):
    cfg, params, batch = _setup()
    ex = X.PipelineExecutor(cfg, _spec(name))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = ex.step(params, batch, trace=trace)
    return res, prof


def _host(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]


def _within(inner, outers):
    a, b = inner.time_range.start, inner.time_range.end
    return any(o.time_range.start <= a and b <= o.time_range.end for o in outers)


def test_no_profiler_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert ranges.span("pipe.F") is ranges.NULL
    assert ranges.span("cast") is ranges.span("moe_dispatch")
    cfg, params, batch = _setup()
    t0 = ranges.now_ns()
    res = X.PipelineExecutor(cfg, _spec("bpipe")).step(params, batch)
    assert torch.isfinite(res.loss)
    assert t0 <= res.t0_ns <= ranges.now_ns()


def test_the_shared_clock_is_the_epoch():
    assert abs(ranges.now_ns() - time.time_ns()) < 50 * MS


@pytest.mark.parametrize("name", sorted(SPECS))
def test_one_range_per_retired_instruction(name):
    _, prof = _profiled_step(name)
    got = collections.Counter(e.name for e in _host(prof) if e.name.startswith("pipe."))
    schedule = P.compile_plan(_spec(name))
    want = collections.Counter(X._range_name(ins)
                               for stream in schedule.streams.values() for ins in stream)
    p, m = 4, MICRO
    assert want["pipe.F"] == want["pipe.B"] == p * m
    if name == "bpipe":
        assert want["pipe.EVICT"] > 0 and want["pipe.LOAD"] > 0
    if name == "selective_recompute":
        assert want["pipe.RECOMPUTE"] > 0
    for key in ("pipe.step", "pipe.split", "pipe.merge"):
        assert got.pop(key) == 1, key
    assert got.pop("pipe.grad_sum") == p * m
    assert got == want


@pytest.mark.parametrize("name", ["bpipe", "selective_recompute"])
def test_model_and_cast_ranges_nest_in_instructions(name):
    _, prof = _profiled_step(name)
    host = _host(prof)
    by = collections.defaultdict(list)
    for e in host:
        by[e.name].append(e)
    fwd = by["pipe.F"] + by["pipe.RECOMPUTE"]
    assert by["moe_dispatch"] and by["moe_combine"] and by["cast"]
    for e in by["moe_dispatch"] + by["moe_combine"]:
        assert _within(e, fwd), e.name
    # on the CPU the backward runs on the calling thread, inside pipe.B
    for e in by["cast"]:
        assert _within(e, fwd + by["pipe.B"]), e.name
    for e in by["pipe.grad_sum"]:
        assert _within(e, by["pipe.B"])
    # rope: one range a layer forward, q and k together (the plain chain on
    # the CPU: no backward range)
    assert by["rope"] and all(_within(e, fwd) for e in by["rope"])
    assert len(by["rope"]) == len(fwd) * (LAYERS // 4)
    steps = by["pipe.step"]
    for e in host:
        if e.name.startswith("pipe.") and e.name != "pipe.step":
            assert _within(e, steps), e.name


@pytest.mark.parametrize("name", ["bpipe", "host_offload"])
def test_recorder_spans_land_on_their_ranges(name):
    res, prof = _profiled_step(name, trace=True)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ops = {X._range_name(ins) for s in P.compile_plan(_spec(name)).streams.values()
           for ins in s}
    rng = sorted((e for e in _host(prof) if e.name in ops), key=lambda e: e.time_range.start)
    spans = [s for s in res.events if s.track == "compute"]
    assert len(spans) == len(rng) > 0
    for s, e in zip(spans, rng):
        name_ = f"pipe.{s.op}.wait" if s.phase == "wait" else f"pipe.{s.op}"
        assert name_ == e.name
        a = res.t0_ns + s.start * 1e9
        b = res.t0_ns + s.end * 1e9
        r0 = start_ns + e.time_range.start * 1e3
        r1 = start_ns + e.time_range.end * 1e3
        assert r0 - MS <= a <= b <= r1 + MS, (e.name, a - r0, r1 - b)
