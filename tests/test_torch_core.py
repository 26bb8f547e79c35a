"""The port's own copies of the JAX package's framework-free layer (schedule
notation, kinds, compiled plans, memory model, residency policies, store,
transfer channels and engine, event schema and the rest of the obs layer,
BPipe pairing, the estimator, FLOP counts, the simulator, the planner and
the long-context cases), held to the originals.

Each copy is the original with ``repro.`` rewritten to ``repro_torch.``:
their code (the AST without docstrings, which may speak of the port's own
mechanism) is equal. ``planner/calibrate.py`` and ``obs/compare.py`` are
copies less the three functions that build an executor (their torch
versions are ``planner/measure.py``'s). Their behaviour is checked as well: compiled plans,
stash accounting, memory-model bytes and the policy registries agree, and
registering a policy clears the port's plan cache, not the JAX package's.
"""
import ast
import dataclasses
import pathlib
import re

import pytest

from repro.core import memory_model as JMM
from repro.core import notation as JN
from repro.core import plan as JP
from repro.memory import policy as JPOL
from repro_torch.core import memory_model as TMM
from repro_torch.core import notation as TN
from repro_torch.core import plan as TP
from repro_torch.memory import offload as toffload
from repro_torch.memory import policy as TPOL

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
COPIES = ["core/notation.py", "core/schedule.py", "core/plan.py",
          "core/memory_model.py", "memory/__init__.py", "memory/policy.py",
          "memory/recompute.py", "memory/store.py", "transfer/channel.py",
          "obs/events.py",
          "core/bpipe.py", "core/estimator.py", "core/flops.py",
          "core/simulator.py", "transfer/engine.py", "transfer/__init__.py",
          "obs/__init__.py", "obs/timeline.py", "obs/export.py",
          "obs/metrics.py", "planner/__init__.py", "planner/space.py",
          "planner/feasibility.py", "planner/rank.py", "planner/report.py",
          "configs/longcontext.py"]
# copies less the functions that build an executor (planner/measure.py)
PARTIAL_COPIES = {"planner/calibrate.py": ("measure_stage_T",
                                           "measure_stage_gain"),
                  "obs/compare.py": ("audit",)}


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _tree(path, rewrite=False):
    src = path.read_text()
    if rewrite:
        src = re.sub(r"\brepro\.", "repro_torch.", src)
    return _strip_docstrings(ast.parse(src))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_original(rel):
    copy = _tree(SRC / "repro_torch" / rel)
    orig = _tree(SRC / "repro" / rel, rewrite=True)
    assert ast.dump(copy) == ast.dump(orig)


@pytest.mark.parametrize("rel", sorted(PARTIAL_COPIES))
def test_partial_copy_equals_original_less_its_executor_functions(rel):
    moved = PARTIAL_COPIES[rel]
    orig = _tree(SRC / "repro" / rel, rewrite=True)
    assert {n.name for n in orig.body
            if isinstance(n, ast.FunctionDef)} >= set(moved)
    orig.body = [n for n in orig.body
                 if not (isinstance(n, ast.FunctionDef) and n.name in moved)]
    copy = _tree(SRC / "repro_torch" / rel)
    assert ast.dump(copy) == ast.dump(orig)


def _node(tree, name):
    return next(n for n in tree.body if getattr(n, "name", None) == name
                or (isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", None) == name))


@pytest.mark.parametrize("rel,name", [
    ("transfer/runtime.py", "AsyncTransferRuntime"),
    ("memory/offload.py", "HOST_OFFLOAD"),
    ("launch/plan.py", "resolve_config"),
    ("launch/plan.py", "main"),
    ("pipeline/spmd.py", "_bpipe_perms"),
    ("launch/roofline.py", "extrapolate"),
])
def test_port_modules_keep_the_originals_parts(rel, name):
    """``runtime`` and ``offload`` differ from their twins in how a copy is
    made and waited for; the depth-capped runtime and the policy they
    register are the originals'. ``launch/plan.py`` differs in its chip and
    link tables (the H100 figures); its CLI is the original's. ``spmd`` and
    ``roofline`` run over torch.distributed and H100 constants; the BPipe
    eviction permutation and the block extrapolation are the originals'."""
    copy = _node(_tree(SRC / "repro_torch" / rel), name)
    orig = _node(_tree(SRC / "repro" / rel, rewrite=True), name)
    assert ast.dump(copy) == ast.dump(orig)


def _spec_sweep():
    out = []
    for kind in ("gpipe", "1f1b", "bpipe", "1f1b_interleaved",
                 "bpipe_interleaved"):
        for p in (2, 3, 4):
            for m in (4, 6, 8):
                for res in ("none", "host_offload", "selective_recompute"):
                    for cap in (None, 2, 3):
                        for depth in (1, 2):
                            kw = dict(v=2, cap=cap, residency=res, depth=depth)
                            try:
                                spec = JP.ScheduleSpec(kind, p, m, **kw)
                                JP.compile_plan(spec)
                            except (AssertionError, IndexError, ValueError):
                                continue
                            if spec not in out:
                                out.append(spec)
    return out


SPECS = _spec_sweep()


def _plain(x):
    """Dataclasses of either package as plain tuples, recursively."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def test_spec_sweep_is_wide():
    kinds = {s.kind for s in SPECS}
    assert len(SPECS) > 100 and len(kinds) == 5
    assert {s.residency for s in SPECS} >= {"none", "host_offload",
                                            "selective_recompute",
                                            "bpipe_swap"}


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "bpipe", "1f1b_interleaved",
                                  "bpipe_interleaved"])
def test_compiled_plans_equal(kind):
    for spec in (s for s in SPECS if s.kind == kind):
        j = JP.compile_plan(spec)
        t = TP.compile_plan(TP.ScheduleSpec.from_dict(spec.to_dict()))
        assert _plain(t.streams) == _plain(j.streams), spec
        for field in ("partner", "cap", "bounds", "peak_stash",
                      "num_evictions", "num_loads", "peak_spilled"):
            assert getattr(t, field) == getattr(j, field), (spec, field)
        assert _plain(TP.stash_accounting(t.streams, spec.p, t.partner)) == \
            _plain(JP.stash_accounting(j.streams, spec.p, j.partner)), spec


def test_memory_model_bytes_equal_on_table3_notations():
    kinds = ("gpipe", "1f1b", "bpipe", "1f1b_interleaved", "bpipe_interleaved")
    for name in ("GPT3_96B", "LLAMA_65B"):
        for b in (1, 2, 4):
            jn = getattr(JN, name).replace(b=b)
            tn = getattr(TN, name).replace(b=b)
            assert dataclasses.asdict(tn) == dataclasses.asdict(jn)
            for att in ("none", "recompute", "flash"):
                assert TMM.act_bytes_per_stage(tn, att) == \
                    JMM.act_bytes_per_stage(jn, att)
                assert TMM.sliced_unit_bytes(tn, att, 2, 2) == \
                    JMM.sliced_unit_bytes(jn, att, 2, 2)
                for kind in kinds:
                    v = 2 if "interleaved" in kind else 1
                    assert _plain(TMM.per_stage_memory(tn, att, kind, v=v)) == \
                        _plain(JMM.per_stage_memory(jn, att, kind, v=v)), \
                        (name, b, att, kind)
                    assert TMM.max_stage_bytes(tn, att, kind, v=v) == \
                        JMM.max_stage_bytes(jn, att, kind, v=v)
                assert TMM.balance_report(tn, att) == JMM.balance_report(jn, att)


def test_policy_registries_equal():
    assert sorted(TPOL.POLICIES) == sorted(JPOL.POLICIES)
    assert sorted(TPOL.RELEASE_OPS) == sorted(JPOL.RELEASE_OPS)
    assert sorted(TPOL.RESTORE_OPS) == sorted(JPOL.RESTORE_OPS)
    n_t, n_j = TN.LLAMA_65B, JN.LLAMA_65B
    for name, j in JPOL.POLICIES.items():
        t = TPOL.POLICIES[name]
        for field in ("release_op", "restore_op", "mechanism", "active",
                      "swap", "moves_data"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.retained_bytes(n_t, "flash", 2) == \
            j.retained_bytes(n_j, "flash", 2)
        if j.active:
            for p in range(2, 9):
                for v in (1, 2):
                    assert t.default_cap(p, v) == j.default_cap(p, v)
                    assert t.cap_roof(p, 8, v) == j.cap_roof(p, 8, v)
    assert toffload.HOST_OFFLOAD.name == "host_offload"


def test_registering_a_policy_clears_the_ports_plan_cache_only():
    """The copy's cache hook names ``repro_torch.core.plan``: registering a
    policy in the port clears the port's compile cache and leaves the JAX
    package's (loaded in the same process) alone."""
    spec = dict(kind="bpipe", p=4, m=8)
    TP.compile_plan(TP.ScheduleSpec(**spec))
    JP.compile_plan(JP.ScheduleSpec(**spec))
    assert TP._COMPILE_CACHE and JP._COMPILE_CACHE
    j_before = dict(JP._COMPILE_CACHE)
    TPOL.register(TPOL.ResidencyPolicy("test_cache_probe"))
    try:
        assert not TP._COMPILE_CACHE
        assert dict(JP._COMPILE_CACHE) == j_before
    finally:
        TPOL.unregister("test_cache_probe")
    assert "test_cache_probe" not in JPOL.POLICIES


@pytest.mark.parametrize("needle,home", [
    ("while remaining", "core/plan.py"),
    ("Span(", "obs/events.py"),
])
def test_one_dispatch_loop_and_one_span_module(needle, home):
    """The port's twin of ``scripts/check.sh``'s guards: one ready loop
    (``plan.run``) and one module that builds spans."""
    port = SRC / "repro_torch"
    found = sorted(str(f.relative_to(port)) for f in port.rglob("*.py")
                   if needle in f.read_text())
    assert found == [home]
