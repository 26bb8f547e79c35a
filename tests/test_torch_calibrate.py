"""Calibration and sim-vs-real audits in the port, against the JAX package:
every function of ``planner/calibrate.py`` and ``obs/compare.py`` the port
copies, on the same spans; ``planner/measure.py`` (the torch versions of
``measure_stage_T`` / ``measure_stage_gain`` and ``audit``) on the CPU at a
reduced size; and the executor's trace and live stash cap against the JAX
executor's.

Reduced qwen1.5-0.5b, 4 layers, fp32, as ``tests/test_torch_executor.py``:
params from ``repro.models.model.init_params`` through the bridge, tokens
from numpy seeds. Times measured here are CPU times and are checked only
for being finite and positive.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import notation as JN
from repro.core import plan as JP
from repro.core import simulator as JSIM
from repro.models import model as JM
from repro.obs import compare as JOC
from repro.obs import events as JOE
from repro.pipeline import PipelineExecutor as JExecutor
from repro.planner import calibrate as JCAL
from repro.planner import rank as JR
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.core import notation as TN
from repro_torch.core import plan as TP
from repro_torch.core import simulator as TSIM
from repro_torch.obs import Recorder as TRecorder
from repro_torch.obs import compare as TOC
from repro_torch.pipeline import PipelineExecutor
from repro_torch.planner import calibrate as TCAL
from repro_torch.planner import measure
from repro_torch.planner import rank as TR


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads when several test
    workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _one_trace_per_jax_stage():
    """One JAX trace per (cfg, stages, stage, remat) across the executors
    built here (as ``tests/test_torch_executor.py``)."""
    from repro.pipeline import stage as jstage
    plain = jstage.make_stage_fn
    jstage.make_stage_fn = functools.lru_cache(maxsize=None)(plain)
    yield
    jstage.make_stage_fn = plain


_SETUP = {}


def _setup():
    """Both packages' reduced config, params and a 4 x 8 batch."""
    if not _SETUP:
        over = dict(num_layers=4, dtype="float32")
        jc = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), **over)
        tc = dataclasses.replace(tget_config("qwen1.5-0.5b").reduced(), **over)
        p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
        toks = np.random.default_rng(7).integers(0, jc.vocab_size, (4, 9))
        toks = toks.astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        _SETUP.update(
            jc=jc, tc=tc, jp=jax.tree.map(jnp.asarray, p),
            tp=bridge.to_torch(p, device="cpu"),
            jb={k: jnp.asarray(v) for k, v in batch.items()},
            tb={k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()})
    return _SETUP


def _specs(kind, p=4, m=4, **kw):
    spec = JP.ScheduleSpec(kind, p, m, **kw)
    return spec, TP.ScheduleSpec.from_dict(spec.to_dict())


_TRACES = {}


def _port_trace(kind="bpipe", residency="none"):
    """The port executor's traced step of ``kind`` (p 4, m 4)."""
    if (kind, residency) not in _TRACES:
        d = _setup()
        _, ts = _specs(kind, residency=residency)
        _TRACES[kind, residency] = PipelineExecutor(d["tc"], ts).step(
            d["tp"], d["tb"], trace=True).events
    return _TRACES[kind, residency]


def _to_jax(spans):
    return [JOE.make(s.op, s.stage, s.mb, s.chunk, s.sl, s.phase, s.start,
                     s.end, s.track, s.channel, s.hbm) for s in spans]


def _tuples(spans):
    return [dataclasses.astuple(s) for s in spans]


# ---------------------------------------------------------------------------
# The executor's trace and options against the JAX executor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,residency", [
    ("1f1b", "none"), ("bpipe", "none"), ("1f1b", "host_offload"),
    ("1f1b", "selective_recompute")])
def test_traced_span_keys_equal_jax_executor(kind, residency):
    d = _setup()
    js, _ = _specs(kind, residency=residency)
    want = JExecutor(d["jc"], spec=js).step(d["jp"], d["jb"], trace=True)
    got = _port_trace(kind, residency)
    for track in ("compute", "channel"):
        assert sorted((s.key, s.channel) for s in got if s.track == track) \
            == sorted((s.key, s.channel) for s in want.events
                      if s.track == track), track
    assert all(s.end >= s.start >= 0.0 for s in got)


def test_live_stash_cap_fires_in_both_executors():
    """With every stage's live bound cut to 1 unit, the stash-cap assertion
    (always on in the port, on by default in the JAX executor) stops both
    executors' bpipe step."""
    d = _setup()
    js, ts = _specs("bpipe")
    runs = ((JExecutor(d["jc"], spec=js), JP, d["jp"], d["jb"]),
            (PipelineExecutor(d["tc"], ts), TP, d["tp"], d["tb"]))
    for ex, plan, params, batch in runs:
        ex._schedule_for = lambda m, ex=ex, plan=plan: dataclasses.replace(
            plan.compile_plan(ex.spec.with_m(m)),
            bounds={i: 1 for i in range(4)})
        with pytest.raises(AssertionError):
            ex.step(params, batch)


# ---------------------------------------------------------------------------
# planner/calibrate.py: each copied function on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("v,b,c", [(1, 0, 1), (2, 1, 1), (1, 2, 2)])
@pytest.mark.parametrize("kind,residency", [("bpipe", "none"),
                                            ("1f1b", "host_offload")])
def test_fit_trace_equals_reference(kind, residency, v, b, c):
    spans = _port_trace(kind, residency)
    got = TCAL.fit_trace(spans, v=v, b=b, seq_chunks=c)
    want = JCAL.fit_trace(_to_jax(spans), v=v, b=b, seq_chunks=c)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.t_move == want.t_move
    assert got.Tf > 0 and got.Tb > 0 and got.samples == len(spans)


COSTS = dict(Tf=1.5e-3, Tb=3.25e-3, t_evict=2e-4, t_load=3e-4, v=1, b=2,
             samples=40)


@pytest.mark.parametrize("spec_kw", [
    dict(kind="bpipe", p=4, m=8), dict(kind="1f1b", p=4, m=8),
    dict(kind="bpipe_interleaved", p=2, m=4, v=2),
    dict(kind="1f1b", p=4, m=8, residency="host_offload")],
    ids=lambda kw: "-".join(map(str, kw.values())))
def test_apply_and_replay_equal_reference(spec_kw):
    tc, jc = TCAL.CalibratedCosts(**COSTS), JCAL.CalibratedCosts(**COSTS)
    ts, js = TP.ScheduleSpec(**spec_kw), JP.ScheduleSpec(**spec_kw)
    tcfg = TCAL.apply(tc, TSIM.SimConfig(spec=ts, Tf=1.0, Tb=2.0))
    jcfg = JCAL.apply(jc, JSIM.SimConfig(spec=js, Tf=1.0, Tb=2.0))
    assert (tcfg.Tf, tcfg.Tb) == (jcfg.Tf, jcfg.Tb) == (1.5e-3, 3.25e-3)
    kw = dict(evict_bytes=2.0, pair_bw=8.0, t_p2p=1e-4)
    got, want = TCAL.replay(tc, ts, **kw), JCAL.replay(jc, js, **kw)
    assert (got.makespan, got.load_stall, got.busy) == \
        (want.makespan, want.load_stall, want.busy)
    legacy = dict(p=spec_kw["p"], m=spec_kw["m"], v=spec_kw.get("v", 2),
                  cap=3)
    got = TCAL.replay(tc, spec_kw["kind"], **legacy)
    want = JCAL.replay(jc, spec_kw["kind"], **legacy)
    assert (got.makespan, got.busy) == (want.makespan, want.busy)


@pytest.mark.parametrize("traced", ["none", "recompute", "flash"])
def test_trace_cost_model_equals_reference(traced):
    tm = TCAL.TraceCostModel(TCAL.CalibratedCosts(**COSTS), attention=traced,
                             peak_per_chip=989e12)
    jm = JCAL.TraceCostModel(JCAL.CalibratedCosts(**COSTS), attention=traced,
                             peak_per_chip=989e12)
    assert isinstance(tm, TR.CostModel) and isinstance(jm, JR.CostModel)
    for b in (1, 2, 4, 8):
        for arm in ("none", "recompute", "flash"):
            tn = TN.LLAMA_65B.replace(b=b)
            jn = JN.LLAMA_65B.replace(b=b)
            assert tm.stage_T(tn, arm) == jm.stage_T(jn, arm) > 0
    assert tm.peak_per_chip == jm.peak_per_chip == 989e12


def test_chrome_trace_aliases_round_trip_into_the_reference(tmp_path):
    spans = _port_trace("bpipe")
    assert TCAL.chrome_trace(spans) == JCAL.chrome_trace(_to_jax(spans))
    path = str(tmp_path / "port.json")
    TCAL.save_chrome_trace(spans, path)
    assert _tuples(JCAL.load_chrome_trace(path)) == _tuples(spans)
    assert _tuples(TCAL.load_chrome_trace(path)) == _tuples(spans)


# ---------------------------------------------------------------------------
# obs/compare.py: each copied function on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,residency", [
    ("1f1b", "none"), ("bpipe", "none"), ("1f1b", "host_offload")])
def test_compare_equals_reference_on_a_real_trace(kind, residency):
    real = _port_trace(kind, residency)
    _, ts = _specs(kind, residency=residency)
    costs = TCAL.fit_trace(real, b=1)
    rec = TRecorder()
    TSIM.simulate(TSIM.SimConfig(spec=ts, Tf=costs.Tf, Tb=costs.Tb),
                  observer=rec)
    got = TOC.compare(rec.spans, real, label=ts.label())
    want = JOC.compare(_to_jax(rec.spans), _to_jax(real), label=ts.label())
    assert got.to_dict() == want.to_dict()
    assert got.format() == want.format()
    assert got.instruction_sets_match == want.instruction_sets_match is True
    assert got.max_order_divergence == want.max_order_divergence


@pytest.mark.parametrize("sim,real", [
    ([1, 2, 3], [1, 2, 3]), ([1, 2, 3], [3, 2, 1]), ([], []),
    (list(range(9)), [4, 0, 8, 1, 7, 2, 6, 3, 5]), ([1, 2, 3], [2, 9, 1])])
def test_order_divergence_equals_reference(sim, real):
    assert TOC.order_divergence(sim, real) == JOC.order_divergence(sim, real)
    seq = list(real)
    assert TOC._inversions(list(seq)) == JOC._inversions(list(seq))


# ---------------------------------------------------------------------------
# planner/measure.py on the CPU
# ---------------------------------------------------------------------------
def test_measure_stage_gain_on_the_cpu():
    d = _setup()
    res = measure.measure_stage_gain(d["tc"], 2, 1, seq=8, device="cpu")
    for key in ("Tx", "Ty", "gain"):
        assert math.isfinite(res[key]) and res[key] > 0, key
    assert (res["bx"], res["by"]) == (2, 1)
    assert res["costs_x"].b == 2 and res["costs_y"].b == 1
    assert res["Tx"] == res["costs_x"].Tf + res["costs_x"].Tb
    assert res["gain"] == pytest.approx((2 / res["Tx"]) / (1 / res["Ty"]))


@pytest.mark.parametrize("kind", ["1f1b", "bpipe"])
def test_audit_on_the_cpu_finds_one_census(kind):
    d = _setup()
    rep = measure.audit(d["tc"], TP.ScheduleSpec(kind, 4, 4), seq=8,
                        device="cpu")
    assert rep.missing_in_real == [] and rep.missing_in_sim == []
    assert rep.sim_count == rep.real_count > 0
    assert math.isfinite(rep.time_scale) and rep.time_scale > 0
    assert {s.op for s in rep.op_skew} >= {"F", "B"}
    assert set(rep.order_div) == {0, 1, 2, 3}


def test_measure_defaults_to_the_card():
    import inspect
    for fn in (measure.measure_stage_T, measure.measure_stage_gain,
               measure.audit):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure.measure_stage_T(_setup()["tc"], 1)
