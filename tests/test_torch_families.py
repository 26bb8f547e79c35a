"""The MoE and RG-LRU hybrid families end to end in the port vs the JAX
package (fp32, CPU): granite-moe-1b-a400m (32 experts top 8; 4 top 2 at
smoke scale) and recurrentgemma-2b (RGLRU, RGLRU, LOCAL).

Params come from ``repro.models.model.init_params`` through the bridge,
tokens from numpy seeds, seq <= 32. Bounds: loss 1e-5 and grads 2e-4 /
1e-3 (tests/test_torch_train.py), logits 2e-4 (tests/test_models.py and
tests/test_torch_model.py); the executor twins of tests/test_executor.py
keep that file's bounds. The MoE runs with the config's capacity factor
(drops) except where a test says why not.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import plan as JP
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.pipeline import PipelineExecutor as JExecutor
from repro.pipeline import stage as jstage
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import plan as TP
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.optim import adam as tadam
from repro_torch.pipeline import PipelineExecutor
from repro_torch.pipeline import stage as tstage
from repro_torch.serve import serve
from repro_torch.train import steps as TS

LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 1e-3
LOGIT_TOL = 2e-4
FAMILIES = ["granite-moe-1b-a400m", "recurrentgemma-2b"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads (see
    tests/test_torch_executor.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, no_drops=False, **over):
    """(JAX cfg, port cfg) at smoke scale in fp32. recurrentgemma's default
    depth is 4: one (RGLRU, RGLRU, LOCAL) block plus a remainder layer."""
    over = dict(dict(dtype="float32",
                     num_layers=4 if arch == "recurrentgemma-2b" else 2), **over)
    j = dataclasses.replace(get_config(arch).reduced(), **over)
    t = dataclasses.replace(tget_config(arch).reduced(), **over)
    if no_drops and j.moe is not None:
        # a token's choices never reach the drop bin, so a decode step (one
        # token, its own capacity) routes as the forward over the sequence
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=float(j.moe.num_experts)))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=float(t.moe.num_experts)))
    return j, t


def _params(jc, seed=0):
    p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jc))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _trees_close(got, want, atol, rtol):
    want = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(T.leaves_with_paths(got))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol,
                                   rtol=rtol, err_msg="/".join(k))


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_jax(arch, impl, remat):
    """loss_fn (cross-entropy + the MoE aux) and its grads."""
    jc, tc = _cfgs(arch, attn_impl=impl)
    jp, tp = _params(jc)
    batch = _batch(jc)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(p, _jb(batch), jc, remat=remat), has_aux=True)(jp)
    tl, tg = TS.make_loss_grad(tc, TrainConfig(remat=remat))(tp, _tb(batch))
    _, tm = TM.loss_fn(tp, _tb(batch), tc, remat=remat)
    assert abs(float(tl) - float(jl)) < LOSS_TOL
    assert abs(float(tm["aux"]) - float(jm["aux"])) < LOSS_TOL
    if jc.moe is not None:
        assert float(tm["aux"]) > 0.0
    _trees_close(tg, jg, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_track_jax(arch):
    """make_train_step (flash arm) on make_batch's data: each step's loss
    within 1e-4 of the JAX step's, the params after two steps within
    2e-4 / 1e-3."""
    jc, tc = _cfgs(arch, attn_impl="flash")
    jp, tp = _params(jc)
    kw = dict(global_batch=2, seq_len=16, steps=2, warmup_steps=1,
              learning_rate=1e-3)
    jstep = JS.make_train_step(jc, JTrainConfig(**kw))
    tstep = TS.make_train_step(tc, TrainConfig(**kw))
    jst, tst = jadam.init(jp), tadam.init(tp)
    dc = jdata.DataConfig(batch=2, seq_len=16, seed=3)
    for i in range(2):
        batch = jdata.make_batch(jc, dc, i)
        jp, jst, jm = jstep(jp, jst, _jb(batch))
        tp, tst, tm = tstep(tp, tst, _tb(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   atol=1e-4)
    _trees_close(tp, jp, GRAD_ATOL, GRAD_RTOL)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=LOGIT_TOL)


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_decode_match(arch, impl):
    """forward logits, then prefill and 4 decode steps (the RG-LRU's h and
    conv tail, the local layer's ring cache) against JAX and against the
    port's own forward. The MoE runs without drops here: a decode step
    routes one token with its own capacity, so only then does decoding
    equal the forward (tests/test_models.py does the same)."""
    jc, tc = _cfgs(arch, no_drops=True, attn_impl=impl)
    jp, tp = _params(jc)
    b, s, n_dec = 2, 20, 4
    toks = np.random.default_rng(0).integers(
        0, jc.vocab_size, size=(b, s)).astype(np.int32)
    want, _ = JM.forward(jp, {"tokens": jnp.asarray(toks)}, jc)
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    _close(got, want)
    sp = s - n_dec
    jst = JM.init_decode_state(jc, b, s)
    tst = TM.init_decode_state(tc, b, s, device="cpu")
    jl, jst, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :sp])}, jc, jst)
    tl, tst, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :sp]).long()},
                            tc, tst)
    _close(tl, jl)
    _trees_close(tst, jst, LOGIT_TOL, 0)
    for i in range(sp, s):
        jl, jst = JM.decode_step(jp, jnp.asarray(toks[:, i]), jnp.int32(i), jst, jc)
        tl, tst = TM.decode_step(tp, torch.from_numpy(toks[:, i]).long(), i,
                                 tst, tc)
        _close(tl, jl)
        _close(tl, want[:, i])
    _trees_close(tst, jst, LOGIT_TOL, 0)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_shorter_than_conv_and_window(arch):
    """A prompt of 2 tokens: the conv tail is left-padded (cw - 1 = 3) and
    the caches hold fewer tokens than the window; prefill and 3 decode
    steps equal JAX's."""
    jc, tc = _cfgs(arch, no_drops=True)
    jp, tp = _params(jc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (3, 5)).astype(np.int32)
    jst = JM.init_decode_state(jc, 3, 5)
    tst = TM.init_decode_state(tc, 3, 5, device="cpu")
    jl, jst, _ = JM.prefill(jp, {"tokens": jnp.asarray(toks[:, :2])}, jc, jst)
    tl, tst, _ = TM.prefill(tp, {"tokens": torch.from_numpy(toks[:, :2]).long()},
                            tc, tst)
    _close(tl, jl)
    _trees_close(tst, jst, LOGIT_TOL, 0)
    for i in range(2, 5):
        jl, jst = JM.decode_step(jp, jnp.asarray(toks[:, i]), jnp.int32(i), jst, jc)
        tl, tst = TM.decode_step(tp, torch.from_numpy(toks[:, i]).long(), i,
                                 tst, tc)
        _close(tl, jl)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_equal(arch):
    """The greedy serve loop picks the JAX twin's tokens (the config's
    capacity factor: prefill routes the prompt with drops, as JAX does)."""
    jc, tc = _cfgs(arch, attn_impl="flash")
    jp, tp = _params(jc)
    b, sp, gen = 3, 12, 6
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (b, sp)).astype(np.int32)
    jst = JM.init_decode_state(jc, b, sp + gen)
    logits, jst = JS.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)}, jst)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = [tok]
    step = JS.make_serve_step(jc)
    for i in range(gen - 1):
        tok, _, jst = step(jp, jst, tok, jnp.int32(sp + i))
        want.append(tok)
    res = serve(tp, tc, torch.from_numpy(toks).long(), gen)
    np.testing.assert_array_equal(res["tokens"].numpy(),
                                  np.asarray(jnp.stack(want, 1)))


# ---------------------------------------------------------------------------
# The pipeline executor: twins of tests/test_executor.py:40-101
# ---------------------------------------------------------------------------
def _exec_setup(arch, layers, b, s, moe=None):
    jc, tc = _cfgs(arch, num_layers=layers)
    if moe is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, **moe))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, **moe))
    jp, tp = _params(jc)
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    ref_loss, _ = JM.loss_fn(jp, _jb(batch), jc)
    ref_grads = jax.grad(lambda p: JM.loss_fn(p, _jb(batch), jc)[0])(jp)
    return jc, tc, jp, tp, batch, ref_loss, ref_grads


def test_executor_hybrid_arch():
    """BPipe on the RG-LRU + local attention hybrid: 6 layers (two pattern
    blocks), p 3, one microbatch row; loss 1e-5, grads 5e-6 / 1e-3."""
    jc, tc, jp, tp, batch, ref_loss, ref_grads = _exec_setup(
        "recurrentgemma-2b", layers=6, b=4, s=12)
    res = PipelineExecutor(tc, TP.ScheduleSpec("bpipe", 3, 0),
                           micro_batch=1).step(tp, _tb(batch))
    assert abs(float(res.loss) - float(ref_loss)) < 1e-5
    _trees_close(res.grads, ref_grads, 5e-6, 1e-3)


def test_executor_moe_arch():
    """MoE through the pipeline (p 2, bpipe, 2 rows a microbatch). With aux
    weight 0 and no drops the pipeline equals the full model (atol 1e-5 /
    rtol 1e-3); the router's aux is nonlinear in the batch, so with it on
    each microbatch's aux differs from the full batch's: it is carried
    (the loss rises by less than 0.5) and equals the JAX executor's."""
    base = get_config("granite-moe-1b-a400m").reduced()
    exact = dict(capacity_factor=float(base.moe.num_experts),
                 router_aux_weight=0.0)
    jc, tc, jp, tp, batch, ref_loss, ref_grads = _exec_setup(
        "granite-moe-1b-a400m", layers=4, b=4, s=12, moe=exact)
    res = PipelineExecutor(tc, TP.ScheduleSpec("bpipe", 2, 0),
                           micro_batch=2).step(tp, _tb(batch))
    assert abs(float(res.loss) - float(ref_loss)) < 1e-5
    _trees_close(res.grads, ref_grads, 1e-5, 1e-3)

    moe_aux = dataclasses.replace(tc.moe, router_aux_weight=0.01)
    tc_aux = dataclasses.replace(tc, moe=moe_aux)
    res_aux = PipelineExecutor(tc_aux, TP.ScheduleSpec("bpipe", 2, 0),
                               micro_batch=2).step(tp, _tb(batch))
    assert float(res_aux.loss) > float(res.loss)
    assert abs(float(res_aux.loss - res.loss)) < 0.5
    jc_aux = dataclasses.replace(jc, moe=dataclasses.replace(
        jc.moe, router_aux_weight=0.01))
    jres = JExecutor(jc_aux, p=2, kind="bpipe", micro_batch=2).step(
        jp, _jb(batch))
    assert abs(float(res_aux.loss) - float(jres.loss)) < 1e-5
    _trees_close(res_aux.grads, jres.grads, 1e-5, 1e-3)


def test_stage_split_keeps_the_pattern_and_remainder():
    """7 layers of (RGLRU, RGLRU, LOCAL) over 3 stages: the twin's layer
    assignment, each stage's layers of the right kind, and merge(split)
    giving the params back."""
    jc, tc = _cfgs("recurrentgemma-2b", num_layers=7)
    assert tstage.layer_assignment(tc, 3) == jstage.layer_assignment(jc, 3)
    _, tp = _params(jc)
    splitter = tstage.StageSplitter(tc, 3)
    stages = splitter.split(tp)
    kinds = tc.layer_kinds()
    for sp, layers in zip(stages, splitter.assign):
        for local, ℓ in enumerate(layers):
            mixer = sp["layers"][local]["mixer"]
            assert ("lam" in mixer) == (kinds[ℓ] == "rglru")
    merged = splitter.merge(stages)
    tied = T.tree_map(lambda t: 2 * t, tp["embed"])   # summed over 2 copies
    for path, got in T.leaves_with_paths(merged):
        want = dict(T.leaves_with_paths({**tp, "embed": tied}))[path]
        assert torch.equal(got.detach(), want), path


def test_sliced_recurrent_kinds_raise():
    """seq_chunks > 1 needs attention mixers, as in the twin: the executor
    refuses a recurrent stack, and a sliced RG-LRU layer raises."""
    _, tc = _cfgs("recurrentgemma-2b", num_layers=3)
    with pytest.raises(AssertionError, match="attention mixers"):
        PipelineExecutor(tc, TP.ScheduleSpec("1f1b", 3, 0, seq_chunks=2))
    _, tp = _params(_cfgs("recurrentgemma-2b", num_layers=3)[0])
    layer = T.tree_map(lambda t: t[0], tp["blocks"]["pos0"])
    with pytest.raises(ValueError, match="attention mixers"):
        TB.apply_layer_sliced(layer, torch.zeros(1, 4, tc.d_model), tc, "rglru",
                              torch.zeros(1, 4, dtype=torch.int32), None)


def test_sliced_moe_routes_each_slice():
    """A sliced MoE stack (seq_chunks 2, 1f1b, aux on, the config's capacity
    factor) equals the JAX executor's sliced step: each slice routes with
    the capacity of its own length."""
    jc, tc, jp, tp, batch, *_ = _exec_setup("granite-moe-1b-a400m", layers=2,
                                            b=4, s=16)
    spec = TP.ScheduleSpec("1f1b", 2, 0, seq_chunks=2)
    res = PipelineExecutor(tc, spec, micro_batch=2).step(tp, _tb(batch))
    jres = JExecutor(jc, spec=JP.ScheduleSpec("1f1b", 2, 0, seq_chunks=2),
                     micro_batch=2).step(jp, _jb(batch))
    assert abs(float(res.loss) - float(jres.loss)) < 1e-5
    _trees_close(res.grads, jres.grads, 1e-5, 1e-3)


# ---------------------------------------------------------------------------
# The launchers as a user runs them, on the CPU
# ---------------------------------------------------------------------------
def _run(*args):
    # one intra-op thread, as the in-process tests: beside the other test
    # workers, a launcher's default threads wait on each other for minutes
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_cpu_runs(arch):
    out = _run("repro_torch.launch.train", "--arch", arch, "--reduced",
               "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16")
    lines = [l for l in out.splitlines() if l.startswith("step")]
    assert len(lines) == 2 and "nan" not in out


@pytest.mark.parametrize("arch,stages,layers", [
    ("granite-moe-1b-a400m", 2, 4), ("recurrentgemma-2b", 3, 6)])
def test_launch_pipeline_cpu_runs(arch, stages, layers):
    """Every arm on the same batches: the same losses (the MoE's aux too)."""
    out = _run("repro_torch.launch.pipeline", "--arch", arch, "--reduced",
               "--stages", str(stages), "--layers", str(layers), "--batch",
               "4", "--seq", "12", "--steps", "2", "--device", "cpu")
    losses = {l.split(":")[1].split("peak")[0].strip() for l in out.splitlines()
              if "losses" in l}
    assert len(losses) == 1, out
