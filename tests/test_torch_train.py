"""The port's training slice vs the JAX package's, on the CPU.

Params come from ``repro.models.model.init_params`` through the bridge;
tokens, labels and grads from numpy seeds. Reduced configs in fp32, seq
<= 32. The flash arm takes the port's plain backward here and the Pallas
kernels in interpret mode on the JAX side.

Tolerances, each the JAX package's own or tighter:
  loss 1e-5 (``tests/test_executor.py``'s); grads atol 2e-4 / rtol 1e-3
  (the flash backward test's, ``tests/test_kernels.py``); Adam 1e-6 (both
  sides do the same fp32 ops, in another order of rounding); three train
  steps 1e-4 on each loss (a step's rounding feeds the next);
  data, checkpoints and the remat arms' own equality are exact or 1e-6.
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

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jdata
from repro.models import model as JM
from repro.optim import adam as jadam
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as TM
from repro_torch.optim import adam as tadam
from repro_torch.train import steps as TS

LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
ARCHS = ["llama-65b", "gpt3-96b", "qwen1.5-0.5b"]  # qwen: tied embeddings
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(arch, **over):
    over = dict(dict(dtype="float32", num_layers=3), **over)
    return (dataclasses.replace(get_config(arch).reduced(), **over),
            dataclasses.replace(tget_config(arch).reduced(), **over))


def _params(jc, seed=0):
    """(JAX params, port params): the same values."""
    p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jc))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    """Tokens and next-token labels, a few of them masked (-1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"tokens": toks[:, :-1], "labels": labels}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_trees_close(got, want, atol, rtol):
    """``got``: port tensors; ``want``: a JAX tree of the same nesting."""
    want = dict(T.leaves_with_paths(jax.tree.map(np.asarray, want)))
    got = dict(T.leaves_with_paths(got))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=atol,
                                   rtol=rtol, err_msg="/".join(k))


def _jax_loss_grad(jc, jp, batch, remat):
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(p, _jb(batch), jc, remat=remat),
        has_aux=True)(jp)
    return loss, metrics, grads


@pytest.mark.parametrize("remat", ["none", "attn", "full"])
@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, impl, remat):
    """loss_fn and its grads (make_loss_grad): loss 1e-5, grads 2e-4/1e-3."""
    jc, tc = _cfgs(arch, attn_impl=impl)
    jp, tp = _params(jc)
    batch = _batch(jc)
    jloss, jmetrics, jgrads = _jax_loss_grad(jc, jp, batch, remat)
    tloss, tgrads = TS.make_loss_grad(tc, TrainConfig(remat=remat))(
        tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL)
    _assert_trees_close(tgrads, jgrads, GRAD_ATOL, GRAD_RTOL)
    total, metrics = TM.loss_fn(tp, _tb(batch), tc, remat=remat)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]),
                               atol=LOSS_TOL)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_entropy_variants_match_jax(arch, fused):
    """log_softmax + gather and logsumexp - masked pick: loss 1e-5, grads
    2e-4/1e-3, and the two variants agree with each other to 1e-5."""
    jc, tc = _cfgs(arch, attn_impl="flash", fused_xent=fused)
    jp, tp = _params(jc, seed=1)
    batch = _batch(jc, seed=1)
    jloss, _, jgrads = _jax_loss_grad(jc, jp, batch, "none")
    tloss, tgrads = TS.make_loss_grad(tc, TrainConfig())(tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), atol=LOSS_TOL)
    _assert_trees_close(tgrads, jgrads, GRAD_ATOL, GRAD_RTOL)
    other, _ = TM.loss_fn(tp, _tb(batch),
                          dataclasses.replace(tc, fused_xent=not fused))
    np.testing.assert_allclose(float(other), float(tloss), atol=LOSS_TOL)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_remat_arms_equal_none_in_the_port(impl):
    """Recompute changes no value: loss and grads of "attn" and "full"
    equal "none" to 1e-6 (3 layers: 2 stacked blocks + none left over,
    and 3 layers of gemma2's pattern of 2: one remainder layer)."""
    for arch in ("llama-65b", "gemma2-9b"):
        _, tc = _cfgs(arch, attn_impl=impl)
        tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
        batch = _tb(_batch(tc))
        want_loss, want = TS.make_loss_grad(tc, TrainConfig())(tp, batch)
        for remat in ("attn", "full"):
            loss, grads = TS.make_loss_grad(tc, TrainConfig(remat=remat))(
                tp, batch)
            np.testing.assert_allclose(float(loss), float(want_loss),
                                       atol=1e-6)
            for (k, g), (_, w) in zip(T.leaves_with_paths(grads),
                                      T.leaves_with_paths(want)):
                np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                           err_msg="/".join(k))


def _grads_like(params, seed, scale):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
        jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("grad_scale", [1e-3, 10.0])  # clip off / on
def test_adam_update_matches_jax(grad_scale):
    """Four updates from the same numpy grads: params, moments, grad norm
    and lr to 1e-6 (weight decay on, warmup then cosine)."""
    jc, _ = _cfgs("gpt3-96b", num_layers=2)
    jp, tp = _params(jc)
    kw = dict(steps=6, warmup_steps=2, learning_rate=1e-2, weight_decay=0.1)
    jt, tt = JTrainConfig(**kw), TrainConfig(**kw)
    jst, tst = jadam.init(jp), tadam.init(tp)
    for i in range(4):
        g = _grads_like(jp, i, grad_scale)
        jp, jst, jm = jadam.update(jp, jax.tree.map(jnp.asarray, g), jst, jt)
        tp, tst, tm = tadam.update(tp, bridge.to_torch(g, device="cpu"), tst, tt)
        assert int(tst.step) == int(jst.step) == i + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        _assert_trees_close(tp, jp, 1e-6, 1e-6)
        _assert_trees_close(tst.m, jst.m, 1e-6, 1e-6)
        _assert_trees_close(tst.v, jst.v, 1e-6, 1e-6)


def test_lr_schedule_matches_jax():
    kw = dict(steps=40, warmup_steps=5, learning_rate=3e-4)
    for step in range(0, 45, 3):
        want = jadam.lr_schedule(JTrainConfig(**kw), jnp.int32(step))
        got = tadam.lr_schedule(TrainConfig(**kw),
                                torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_three_train_steps_track_jax():
    """make_train_step (flash arm, remat attn) on make_batch's data: each
    step's loss within 1e-4 of the JAX step's, and the params after three
    steps within 2e-4/1e-3."""
    jc, tc = _cfgs("llama-65b", attn_impl="flash", num_layers=2)
    jp, tp = _params(jc)
    kw = dict(global_batch=2, seq_len=16, steps=3, warmup_steps=1,
              learning_rate=1e-3, remat="attn")
    jstep = JS.make_train_step(jc, JTrainConfig(**kw))
    tstep = TS.make_train_step(tc, TrainConfig(**kw))
    jst, tst = jadam.init(jp), tadam.init(tp)
    dc = jdata.DataConfig(batch=2, seq_len=16, seed=3)
    for i in range(3):
        batch = jdata.make_batch(jc, dc, i)
        jp, jst, jm = jstep(jp, jst, _jb(batch))
        tp, tst, tm = tstep(tp, tst, _tb(batch))
        assert set(tm) == set(jm) == {"loss", "aux", "total", "grad_norm",
                                      "lr"}
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=1e-4)
    _assert_trees_close(tp, jp, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("arch", ["llama-65b", "qwen1.5-0.5b", "internvl2-1b",
                                  "whisper-small"])
def test_make_batch_equals_jax_bit_for_bit(arch):
    """Drift guard of the data copy: the same arrays for several steps,
    seeds and frontends (vision prefixes, encoder frames; reduced widths)."""
    jc, tc = get_config(arch).reduced(), tget_config(arch).reduced()
    for seed, b, s in ((0, 2, 24), (7, 3, 32)):
        for step in (0, 1, 5):
            want = jdata.make_batch(jc, jdata.DataConfig(b, s, seed), step)
            got = tdata.make_batch(tc, tdata.DataConfig(b, s, seed), step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    assert tdata.ENCODER_FRAMES == JM.ENCODER_FRAMES
    np.testing.assert_array_equal(
        tdata.make_decode_inputs(tc, 4, 2, 1)["token"],
        jdata.make_decode_inputs(jc, 4, 2, 1)["token"])
    got = list(tdata.iterate(tc, tdata.DataConfig(1, 8), 2))
    want = list(jdata.iterate(jc, jdata.DataConfig(1, 8), 2))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def _state_with_bf16(jc, seed):
    """A JAX {params, opt} tree whose embed leaves are bf16."""
    jp, _ = _params(jc, seed)
    jp["embed"] = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp["embed"])
    st = jadam.init(jp)
    st = jadam.AdamState(step=jnp.int32(7), m=jax.tree.map(lambda a: a + 1, st.m),
                         v=jax.tree.map(lambda a: a + 2, st.v))
    return {"params": jp, "opt": st}


def _template(tree):
    """The port twin of a JAX {params, opt} tree, zeroed, same dtypes."""
    z = lambda t: bridge.to_torch(jax.tree.map(
        lambda a: np.zeros(a.shape, np.asarray(a).dtype), t), device="cpu")
    return {"params": z(tree["params"]),
            "opt": tadam.AdamState(step=torch.zeros((), dtype=torch.int32),
                                   m=z(tree["opt"].m), v=z(tree["opt"].v))}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def test_checkpoint_from_jax_restores_in_the_port(tmp_path):
    jc, _ = _cfgs("qwen1.5-0.5b", num_layers=2)
    want = _state_with_bf16(jc, 0)
    path = str(tmp_path / "ckpt.npz")
    jckpt.save(path, want)
    got = tckpt.restore(path, _template(want))
    assert int(got["opt"].step) == 7 and got["opt"].step.dtype == torch.int32
    for g_tree, w_tree in ((got["params"], want["params"]),
                           (got["opt"].m, want["opt"].m),
                           (got["opt"].v, want["opt"].v)):
        w = dict(T.leaves_with_paths(bridge.to_numpy(bridge.to_torch(
            jax.tree.map(np.asarray, w_tree), device="cpu"))))
        for k, t in T.leaves_with_paths(g_tree):
            np.testing.assert_array_equal(_bits(bridge.to_numpy({"x": t})["x"]),
                                          _bits(w[k]), err_msg="/".join(k))
    assert got["params"]["embed"]["table"].dtype == torch.bfloat16


def test_checkpoint_from_the_port_restores_in_jax(tmp_path):
    jc, _ = _cfgs("llama-65b", num_layers=2)
    jtree = _state_with_bf16(jc, 1)
    tree = _template(jtree)
    tree["params"] = bridge.to_torch(jax.tree.map(np.asarray, jtree["params"]),
                                     device="cpu")
    tree["opt"].step.fill_(7)
    for t in T.leaves(tree["opt"].m):
        t.fill_(1.5)
    path = str(tmp_path / "ckpt.npz")
    tckpt.save(path, tree)
    got = jckpt.restore(path, jtree)
    assert int(got["opt"].step) == 7
    want = bridge.to_numpy(tree["params"])
    for path_, leaf in jax.tree_util.tree_flatten_with_path(got["params"])[0]:
        k = tuple(e.key for e in path_)
        w = dict(T.leaves_with_paths(want))[k]
        assert np.asarray(leaf).dtype == w.dtype
        np.testing.assert_array_equal(_bits(leaf), _bits(w))
    for leaf in jax.tree.leaves(got["opt"].m):
        np.testing.assert_array_equal(np.asarray(leaf), 1.5)
    # and back into the port: the same bits again
    again = tckpt.restore(path, _template(jtree))
    for (k, a), (_, b) in zip(T.leaves_with_paths(again["params"]),
                              T.leaves_with_paths(tree["params"])):
        assert torch.equal(a, b), k


def test_checkpoint_restore_checks_keys_and_shapes(tmp_path):
    path = str(tmp_path / "c.npz")
    tckpt.save(path, {"a": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing b"):
        tckpt.restore(path, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(path, {"a": torch.zeros(4)})


def test_launch_train_cpu_runs():
    """The launcher as a user runs it, on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama-65b", "--reduced", "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(lines) == 2 and "loss" in lines[0] and "gnorm" in lines[0]


def test_launch_train_resumes_from_its_checkpoint(tmp_path):
    """Two steps, a checkpoint, then a third step from it: the params of an
    unbroken three-step run, bit for bit."""
    path = str(tmp_path / "run.npz")
    base = ["--arch", "llama-65b", "--reduced", "--device", "cpu",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    tlaunch.main(base + ["--steps", "2", "--ckpt", path])
    resumed = tlaunch.main(base + ["--steps", "3", "--ckpt", path])
    straight = tlaunch.main(base + ["--steps", "3"])
    assert [s["step"] for s in resumed["steps"]] == [2]
    assert resumed["steps"][0]["loss"] == straight["steps"][2]["loss"]
    assert int(resumed["opt"].step) == 3
    for (k, a), (_, b) in zip(T.leaves_with_paths(resumed["params"]),
                              T.leaves_with_paths(straight["params"])):
        assert torch.equal(a, b), k
