"""The port's pipeline executor on the CPU: its own contract (loss and grads
equal the full model's ``loss_fn``, live stash peaks equal the schedule
model's), and a differential against the JAX package's executor over the
schedule specs of ``tests/test_differential.py``, the sequence-sliced ones
included.

Reduced qwen1.5-0.5b (tied embeddings), 4 layers, fp32, as
``tests/test_executor.py``. Params come from ``repro.models.model.init_params``
through the bridge, tokens from numpy seeds. Tolerances are the JAX
executor tests' own: loss 1e-5, grads atol 2e-6 / rtol 1e-4; ``StoreStats``
equal field by field.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import plan as JP
from repro.core import schedule as JS
from repro.memory import policy as jrespol
from repro.models import model as JM
from repro.pipeline import PipelineExecutor as JExecutor
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.core import plan as TP
from repro_torch.core import schedule as S
from repro_torch.memory import offload as mem_offload
from repro_torch.models import model as TM
from repro_torch.pipeline import PipelineExecutor
from repro_torch.pipeline import stage as tstage

LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-6, 1e-4
RESIDENCIES = ("none", "host_offload", "selective_recompute")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads, and when several
    test workers share the cores, every process's BLAS threads waiting on
    each other make a run of small GEMMs minutes long."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def _one_trace_per_jax_stage():
    """The JAX executor jits a fresh stage closure per instance; handing it
    the same function for the same (cfg, stages, stage, remat) lets JAX
    reuse one trace and one compilation across the specs. The functions,
    and so the reference's results, are the same."""
    from repro.pipeline import stage as jstage
    plain, sliced = jstage.make_stage_fn, jstage.make_sliced_stage_fn
    jstage.make_stage_fn = functools.lru_cache(maxsize=None)(plain)
    jstage.make_sliced_stage_fn = functools.lru_cache(maxsize=None)(sliced)
    yield
    jstage.make_stage_fn, jstage.make_sliced_stage_fn = plain, sliced


def _cfgs(layers=4):
    over = dict(num_layers=layers, dtype="float32")
    return (dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), **over),
            dataclasses.replace(tget_config("qwen1.5-0.5b").reduced(), **over))


def _setup(b=8, s=16, seed=11):
    jc, tc = _cfgs()
    p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, (b, s + 1))
    toks = toks.astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jc, tc, p, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _ref(tc, params, batch):
    """The full model's loss and grads (slice 2's ``loss_fn``)."""
    paths, leaves = zip(*T.leaves_with_paths(params))
    req = [t.detach().requires_grad_(True) for t in leaves]
    loss, _ = TM.loss_fn(T.unflatten(paths, req), batch, tc)
    return loss.detach(), torch.autograd.grad(loss, req)


@pytest.mark.parametrize("kind", ["gpipe", "1f1b", "bpipe"])
def test_executor_matches_reference(kind):
    _, tc, p, batch = _setup()
    params, tb = bridge.to_torch(p, device="cpu"), _torch_batch(batch)
    ref_loss, ref_grads = _ref(tc, params, tb)
    res = PipelineExecutor(tc, TP.ScheduleSpec(kind, 4, 0),
                           micro_batch=2).step(params, tb)
    assert abs(float(res.loss - ref_loss)) < LOSS_TOL
    for a, b in zip(T.leaves(res.grads), ref_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)


def test_stash_peaks_match_schedule_model():
    _, tc, p, batch = _setup(b=8)
    params, tb = bridge.to_torch(p, device="cpu"), _torch_batch(batch)
    for kind in ("1f1b", "bpipe", "gpipe"):
        res = PipelineExecutor(tc, TP.ScheduleSpec(kind, 4, 0)).step(params, tb)
        want = S.peak_stash(kind, 4, 8)
        for i in range(4):
            assert res.stats.peak_local[i] <= want[i] + 1
        if kind == "1f1b":
            assert res.stats.peak_local == want
        if kind == "bpipe":
            assert max(res.stats.peak_local.values()) <= S.bpipe_cap(4)
            assert res.stats.evictions == res.stats.loads > 0
            assert res.stats.bytes_moved > 0
        if kind != "bpipe":
            assert res.stats.bytes_moved == 0


@pytest.mark.parametrize("layers,p", [(7, 3), (4, 4), (8, 3), (5, 2), (6, 8)])
def test_layer_assignment_matches_jax(layers, p):
    from repro.pipeline.stage import layer_assignment
    jc, tc = _cfgs(layers)
    assert tstage.layer_assignment(tc, p) == layer_assignment(jc, p)


def test_split_shares_storage_and_merge_restacks():
    """Stage leaves are views of the stacked params (no copy), each a leaf
    of its own; the tied table is one leaf on the first stage and another
    on the last, and merge sums their grads."""
    _, tc, p, _ = _setup()
    params = bridge.to_torch(p, device="cpu")
    sp = tstage.StageSplitter(tc, 2).split(params)
    wq = sp[1]["layers"][0]["mixer"]["wq"]
    assert wq.is_leaf and wq.requires_grad
    assert wq.untyped_storage().data_ptr() == \
        params["blocks"]["pos0"]["mixer"]["wq"].untyped_storage().data_ptr()
    assert sp[0]["embed"]["table"] is not sp[1]["unembed"]["table"]
    grads = [T.tree_map(torch.ones_like, s) for s in sp]
    merged = tstage.StageSplitter(tc, 2).merge(grads)
    assert torch.equal(merged["embed"]["table"],
                       torch.full_like(params["embed"]["table"], 2.0))
    assert merged["blocks"]["pos0"]["mixer"]["wq"].shape == \
        params["blocks"]["pos0"]["mixer"]["wq"].shape


# ---------------------------------------------------------------------------
# Differential against the JAX executor
# ---------------------------------------------------------------------------
def _compiles(spec):
    try:
        JP.compile_plan(spec)
        return True
    except (AssertionError, IndexError, ValueError):
        return False


def _exec_specs():
    """``tests/test_differential.py::_exec_specs`` built the same way: the
    kind x residency x cap x depth cross section a 4-layer model executes
    (p*v <= 4, m=4), plus the sequence-sliced variants (c divides the
    batch's seq 8; sliced specs stay at the default cap)."""
    out = []
    for kind, p, v, c in (("gpipe", 2, 1, 1), ("1f1b", 4, 1, 1),
                          ("bpipe", 4, 1, 1), ("1f1b_interleaved", 2, 2, 1),
                          ("bpipe_interleaved", 2, 2, 1), ("gpipe", 2, 1, 2),
                          ("1f1b", 4, 1, 2), ("bpipe", 4, 1, 2),
                          ("1f1b", 2, 1, 4)):
        entry = JS.SCHEDULES[kind]
        residencies = ("none",) if entry.balanced else RESIDENCIES
        for res in residencies:
            pol = jrespol.POLICIES[res]
            managed = entry.balanced or pol.active
            if entry.balanced:
                default = entry.default_cap(p, v)
            elif pol.active:
                default = pol.default_cap(p, v)
            for cap_delta in (0, -1):
                if cap_delta and (not managed or c > 1):
                    continue
                cap = None if not cap_delta else max(default + cap_delta, 2)
                for depth in (1, 2):
                    try:
                        spec = JP.ScheduleSpec(kind, p, 4, v=v, cap=cap,
                                               residency=res, depth=depth,
                                               seq_chunks=c)
                    except ValueError:
                        continue
                    if _compiles(spec) and spec not in out:
                        out.append(spec)
    return out


EXEC_SPECS = _exec_specs()
_SETUP = {}


def _diff_setup():
    if not _SETUP:
        jc, tc, p, batch = _setup(b=4, s=8, seed=7)
        _SETUP.update(jc=jc, tc=tc, jp=jax.tree.map(jnp.asarray, p),
                      tp=bridge.to_torch(p, device="cpu"),
                      jb={k: jnp.asarray(v) for k, v in batch.items()},
                      tb=_torch_batch(batch))
    return _SETUP


def test_exec_specs_cover_the_cross_section():
    assert len(EXEC_SPECS) == 40
    assert {s.kind for s in EXEC_SPECS} == {
        "gpipe", "1f1b", "bpipe", "1f1b_interleaved", "bpipe_interleaved"}
    assert sum(s.seq_chunks > 1 for s in EXEC_SPECS) == 14


@pytest.mark.parametrize("spec", EXEC_SPECS, ids=lambda s: s.label())
def test_port_matches_jax_executor(spec):
    d = _diff_setup()
    want = JExecutor(d["jc"], spec=spec, micro_batch=1).step(d["jp"], d["jb"])
    got = PipelineExecutor(d["tc"], TP.ScheduleSpec.from_dict(spec.to_dict()),
                           micro_batch=1).step(d["tp"], d["tb"])
    assert abs(float(got.loss) - float(want.loss)) < LOSS_TOL
    jl, tl = jax.tree.leaves(want.grads), T.leaves(got.grads)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL)
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)


SLICED_SPECS = [s for s in EXEC_SPECS if s.seq_chunks > 1]
_PORT_STEPS = {}


def _port_step(spec):
    d = _diff_setup()
    if spec not in _PORT_STEPS:
        _PORT_STEPS[spec] = PipelineExecutor(
            d["tc"], TP.ScheduleSpec.from_dict(spec.to_dict()),
            micro_batch=1).step(d["tp"], d["tb"])
    return _PORT_STEPS[spec]


@pytest.mark.parametrize("spec", SLICED_SPECS, ids=lambda s: s.label())
def test_port_sliced_matches_unchunked(spec):
    """The port's sliced step computes its unchunked twin's training step
    (``tests/test_differential.py::test_executor_sliced_parity_vs_unchunked``
    and its bars: loss 1e-5, grads rtol 1e-3 / atol 1e-5), and its
    residency moves change nothing: it equals the same slicing without a
    residency policy or partner swaps bit for bit."""
    kind = {"bpipe": "1f1b"}.get(spec.kind, spec.kind)
    got = _port_step(spec)
    twin = _port_step(JP.ScheduleSpec(kind, spec.p, spec.m, v=spec.v))
    assert abs(float(got.loss) - float(twin.loss)) < 1e-5
    for a, b in zip(T.leaves(got.grads), T.leaves(twin.grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=1e-5)
    plain = _port_step(JP.ScheduleSpec(kind, spec.p, spec.m, v=spec.v,
                                       seq_chunks=spec.seq_chunks))
    assert torch.equal(got.loss, plain.loss)
    for a, b in zip(T.leaves(got.grads), T.leaves(plain.grads)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The checkpoint trap: remat="attn" under host_offload
# ---------------------------------------------------------------------------
def test_remat_attn_host_offload_moves_every_saved_tensor(monkeypatch):
    """Non-reentrant ``torch.utils.checkpoint`` (remat="attn") saves what it
    keeps with hooks of its own; its inputs must still land in the unit's
    box, or an offloaded unit would leave them on the device. The mover here
    copies each storage, poisons the original with NaN bytes and tags the
    copy: the step must equal plain 1f1b bit for bit (nothing read an
    original after the move), and every tensor the backward unpacks from an
    offloaded box must be a tagged copy."""
    _, tc, p, _ = _setup()
    params = bridge.to_torch(p, device="cpu")
    toks = np.random.default_rng(3).integers(0, tc.vocab_size, (4, 17))
    tb = _torch_batch({"tokens": toks[:, :-1].astype(np.int32),
                       "labels": toks[:, 1:].astype(np.int32)})
    tagged, unpacked, moved_boxes = set(), [], []

    def move(stash):
        box = stash.box
        for i, st in enumerate(box.storages):
            src = torch.empty(0, dtype=torch.uint8).set_(st)
            dst = src.clone()
            src.fill_(0xFF)                      # NaN in every float dtype
            box.storages[i] = dst.untyped_storage()
            tagged.add(dst.untyped_storage().data_ptr())
        moved_boxes.append(box)
        return stash

    plain_unpack = mem_offload.Box.unpack

    def unpack(self, packed):
        t = plain_unpack(self, packed)
        if any(b is self for b in moved_boxes) and not isinstance(packed, torch.Tensor):
            unpacked.append(t.untyped_storage().data_ptr() in tagged)
        return t

    monkeypatch.setattr(mem_offload, "to_host", move)
    monkeypatch.setattr(mem_offload, "to_device", move)
    monkeypatch.setattr(mem_offload.Box, "unpack", unpack)
    spec = TP.ScheduleSpec("1f1b", 4, 4, residency="host_offload")
    res = PipelineExecutor(tc, spec, remat="attn").step(params, tb)
    monkeypatch.undo()
    base = PipelineExecutor(tc, TP.ScheduleSpec("1f1b", 4, 4),
                            remat="attn").step(params, tb)
    assert res.stats.offloads == res.stats.fetches > 0
    assert moved_boxes and all(b.storages for b in moved_boxes)
    assert unpacked and all(unpacked)
    assert torch.equal(res.loss, base.loss)
    for a, b in zip(T.leaves(res.grads), T.leaves(base.grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_sliced_host_offload_moves_the_slice_kv(monkeypatch, remat):
    """A slice's own KV is packed into its unit's box, so OFFLOAD moves it
    with the saved tensors and a later slice's prefix reads the moved copy.
    The mover copies each storage and poisons the original with NaN bytes:
    the sliced host_offload step must equal plain sliced 1f1b bit for bit,
    and every offloaded unit's KV must be in its box (packed, not held)."""
    _, tc, p, _ = _setup()
    params = bridge.to_torch(p, device="cpu")
    toks = np.random.default_rng(5).integers(0, tc.vocab_size, (4, 17))
    tb = _torch_batch({"tokens": toks[:, :-1].astype(np.int32),
                       "labels": toks[:, 1:].astype(np.int32)})
    moved = []

    def move(stash):
        box = stash.box
        for i, st in enumerate(box.storages):
            src = torch.empty(0, dtype=torch.uint8).set_(st)
            dst = src.clone()
            src.fill_(0xFF)                      # NaN in every float dtype
            box.storages[i] = dst.untyped_storage()
        moved.append(stash)
        return stash

    monkeypatch.setattr(mem_offload, "to_host", move)
    monkeypatch.setattr(mem_offload, "to_device", move)
    spec = TP.ScheduleSpec("1f1b", 4, 4, residency="host_offload", seq_chunks=2)
    res = PipelineExecutor(tc, spec, remat=remat).step(params, tb)
    monkeypatch.undo()
    base = PipelineExecutor(tc, TP.ScheduleSpec("1f1b", 4, 4, seq_chunks=2),
                            remat=remat).step(params, tb)
    assert res.stats.offloads == res.stats.fetches > 0
    assert moved and all(g.kv and all(not isinstance(t, torch.Tensor)
                                      for kv in g.kv for t in kv)
                         for g in moved)
    assert torch.equal(res.loss, base.loss)
    for a, b in zip(T.leaves(res.grads), T.leaves(base.grads)):
        assert torch.equal(a, b)


def test_checkpoint_inputs_go_through_the_box():
    """The mechanism the trap test relies on, at its smallest: a tensor that
    non-reentrant checkpoint saves as its input is packed by the outer
    box's hook."""
    from torch.utils.checkpoint import checkpoint
    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4, requires_grad=True)
    box = mem_offload.Box(keep=[w, x])
    with torch.enable_grad(), box.hooks():
        h = x * 2.0
        y = checkpoint(lambda a: (a @ w).tanh(), h, use_reentrant=False)
    assert [st.data_ptr() for st in box.storages] == \
        [h.untyped_storage().data_ptr()]
    gw, gx = torch.autograd.grad(y.sum(), [w, x])
    assert torch.isfinite(gw).all() and torch.isfinite(gx).all()


def test_executor_result_through_its_own_trace():
    """trace=True attaches a Recorder: one span per dispatched compute
    instruction, and no result changes."""
    _, tc, p, batch = _setup(b=4, s=8)
    params, tb = bridge.to_torch(p, device="cpu"), _torch_batch(batch)
    spec = TP.ScheduleSpec("bpipe", 4, 4)
    plain = PipelineExecutor(tc, spec).step(params, tb)
    traced = PipelineExecutor(tc, spec).step(params, tb, trace=True)
    assert plain.events is None and traced.events
    ops = {e.op for e in traced.events}
    assert {"F", "B"} <= ops
    assert torch.equal(plain.loss, traced.loss)
