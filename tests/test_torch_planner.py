"""The port's copy of the planning layer (planner, simulator, estimator,
obs exporter) against the JAX package's: the same ranked plans on every
registry config, the paper's Table 3 verdicts, the golden simulator cases,
pruned search equal to exhaustive search, the same simulated spans on the
executor's schedule specs, and a port trace that the JAX package's loader
reads back span for span.

Everything here is pure Python on both sides; nothing is timed.
"""
import dataclasses
import json
import math
import pathlib

import pytest

import repro.planner as JPL
from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.core import notation as JN
from repro.core import simulator as JSIM
from repro.obs import Recorder as JRecorder
from repro.obs import export as JEXP
from repro_torch import planner as TPL
from repro_torch.configs import get_config as tget_config
from repro_torch.core import estimator as TE
from repro_torch.core import memory_model as TMM
from repro_torch.core import notation as TN
from repro_torch.core import plan as TP
from repro_torch.core import schedule as TS
from repro_torch.core import simulator as TSIM
from repro_torch.obs import Recorder as TRecorder
from repro_torch.obs import export as TEXP
from repro_torch.planner import rank as TR
from repro_torch.planner import space as TSP
from test_torch_executor import EXEC_SPECS

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "plan_golden.json"
CASES = json.loads(GOLDEN.read_text())


def _plain(x):
    """Dataclasses of either package as plain tuples, recursively; floats
    by repr so that NaN rows compare equal."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def _pow2_at_most(n):
    return 1 << (n.bit_length() - 1)


@pytest.mark.parametrize("name", list_configs())
def test_plan_config_equals_reference_on_every_config(name):
    """Each RankedPlan, field by field, at the paper's shape (s 2048, B 128,
    t 4, p the largest power of two up to 8 the depth allows, A100-80G)."""
    jc, tc = jget_config(name), tget_config(name)
    p = min(8, _pow2_at_most(jc.num_layers))
    jn = JN.from_model(jc, b=1, s=2048, B=128, p=p, t=4)
    tn = TN.from_model(tc, b=1, s=2048, B=128, p=p, t=4)
    want = JPL.plan_config(jn, jc, JN.A100_HBM_BYTES)
    got = TPL.plan_config(tn, tc, TN.A100_HBM_BYTES)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert _plain(g) == _plain(w), w.cand


# ---------------------------------------------------------------------------
# Paper Table 3 verdicts (tests/test_planner.py), through the port
# ---------------------------------------------------------------------------
def test_gpt3_verdict_bpipe_wins_under_recompute():
    ranked = TPL.plan_config(TN.GPT3_96B, tget_config("gpt3-96b"),
                             TN.A100_HBM_BYTES)
    rec = TPL.recommend(ranked, "recompute")
    assert rec.cand.kind in TS.BPIPE_FAMILY and rec.cand.b == 2
    assert rec.required_gain == pytest.approx(1.052, abs=5e-4)
    assert rec.achieved_gain == pytest.approx(1.460, abs=5e-4)
    oom = [rp for rp in ranked
           if rp.cand.kind == "1f1b" and rp.cand.b == 2
           and rp.cand.attention == "recompute"
           and rp.cand.residency == "none"]
    assert oom and all(rp.verdict == "infeasible" for rp in oom)
    assert TPL.recommend(ranked, "flash").cand.kind not in TS.BPIPE_FAMILY


def test_llama_verdict_bpipe_rejected_at_break_even():
    ranked = TPL.plan_config(TN.LLAMA_65B, tget_config("llama-65b"),
                             TN.A100_HBM_BYTES)
    for arm in ("recompute", "flash", None):
        assert TPL.recommend(ranked, arm).cand.kind != "bpipe", arm
    rej = [rp for rp in ranked
           if rp.cand.kind == "bpipe" and rp.cand.b == 4
           and rp.cand.attention == "recompute" and rp.cand.cap is None
           and rp.cand.depth == 1]
    assert len(rej) == 1 and rej[0].verdict == "reject"
    assert rej[0].required_gain == pytest.approx(156.0 / 142.0)
    assert rej[0].required_gain == pytest.approx(
        TE.required_stage_gain(TN.LLAMA_65B, 4, 2))
    assert rej[0].achieved_gain == pytest.approx(57.6 / 54.5, rel=1e-3)
    assert TPL.recommend(ranked).cand.kind not in TS.BPIPE_FAMILY
    table = TPL.report.format_table(ranked)
    assert "reject" in table and "1.099" in table


# ---------------------------------------------------------------------------
# Golden simulator cases (tests/test_plan.py), through the port
# ---------------------------------------------------------------------------
def _golden_spec(case):
    return TP.ScheduleSpec(case["kind"], case["p"], case["m"],
                           v=max(case["v"], 1), cap=case["cap"],
                           residency=case.get("residency", "none"),
                           seq_chunks=case.get("seq_chunks", 1))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(c.get(k)) for k in ("kind", "p", "m", "v", "cap", "residency",
                            "seq_chunks")))
def test_golden_simulator(case):
    res = TSIM.simulate(TSIM.SimConfig(
        spec=_golden_spec(case), Tf=1.0, Tb=2.0, t_p2p=0.125,
        evict_bytes=1.0, pair_bw=2.0, pair_hops=1))
    assert res.makespan == case["makespan"]
    assert res.load_stall == case["load_stall"]
    assert res.busy == case["busy"]
    assert dict(TP.compile_plan(_golden_spec(case)).peak_stash) == {
        int(k): v for k, v in case["peak_stash"].items()}


# ---------------------------------------------------------------------------
# Branch-and-bound search (tests/test_planner_bnb.py), through the port
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p,B,headroom", [(2, 8, 1.1), (3, 16, 1.5),
                                          (4, 8, 3.0), (4, 16, 1.1)])
def test_pruned_matches_exhaustive(p, B, headroom):
    n = TN.Notation(a=4, b=1, h=256, l=16, s=128, v=512, B=B, p=p, t=1)
    cost = TR.AnalyticCostModel()
    hbm = headroom * TMM.max_stage_bytes(n, "recompute", "1f1b")
    cands = list(TSP.enumerate_candidates(n, TPL.SearchSpace(vs=(2,))))
    fast = TR.rank(n, cands, cost, hbm, workspace=0.0)
    full = TR.rank(n, cands, cost, hbm, workspace=0.0, exhaustive=True)
    assert len(fast) == len(full)
    for arm in TR.arms_of(full) + [None]:
        bf, bx = TPL.recommend(fast, arm), TPL.recommend(full, arm)
        assert (bf and bf.cand) == (bx and bx.cand), arm
        if bf is not None:
            assert (bf.mfu, bf.makespan) == (bx.mfu, bx.makespan)
    assert TPL.report.summarize("cfg", n, fast) == \
        TPL.report.summarize("cfg", n, full)
    by_cand = {rp.cand: rp for rp in full}
    for rp in fast:
        if rp.verdict != "pruned":
            twin = by_cand[rp.cand]
            assert (rp.verdict, rp.mfu, rp.makespan, rp.move_time, rp.note) \
                == (twin.verdict, twin.mfu, twin.makespan, twin.move_time,
                    twin.note)
    # and the JAX package's pruned search ranks the same rows
    jn = JN.Notation(**dataclasses.asdict(n))
    jfast = JPL.rank.rank(jn, list(JPL.space.enumerate_candidates(
        jn, JPL.SearchSpace(vs=(2,)))), JPL.AnalyticCostModel(), hbm,
        workspace=0.0)
    assert [_plain(r) for r in fast] == [_plain(r) for r in jfast]


# ---------------------------------------------------------------------------
# The simulator and the exporter against the JAX package's
# ---------------------------------------------------------------------------
def _simulated(pkg_sim, recorder, spec):
    rec = recorder()
    res = pkg_sim.simulate(pkg_sim.SimConfig(
        spec=spec, Tf=1.0, Tb=2.0, t_p2p=0.125, evict_bytes=1.0,
        pair_bw=2.0), observer=rec)
    return res, rec


@pytest.mark.parametrize("spec", EXEC_SPECS, ids=lambda s: s.label())
def test_simulator_equals_reference(spec):
    want, jrec = _simulated(JSIM, JRecorder, spec)
    got, trec = _simulated(TSIM, TRecorder,
                           TP.ScheduleSpec.from_dict(spec.to_dict()))
    assert (got.makespan, got.load_stall, got.busy) == \
        (want.makespan, want.load_stall, want.busy)
    assert [_plain(s) for s in trec.spans] == [_plain(s) for s in jrec.spans]
    assert _plain(got.channels) == _plain(want.channels)


@pytest.mark.parametrize("spec", [s for s in EXEC_SPECS if s.kind in (
    "bpipe", "1f1b_interleaved") or s.residency == "host_offload"][:4],
    ids=lambda s: s.label())
def test_port_trace_loads_in_the_reference_loader(spec, tmp_path):
    _, trec = _simulated(TSIM, TRecorder,
                         TP.ScheduleSpec.from_dict(spec.to_dict()))
    path = str(tmp_path / "port.trace.json")
    TEXP.save_trace(trec.spans, path)
    back = JEXP.load_trace(path)
    assert [_plain(s) for s in back] == [_plain(s) for s in trec.spans]
    assert TEXP.to_chrome(trec.spans) == JEXP.to_chrome(back)
