"""The port's SPMD pipeline (``repro_torch/pipeline/spmd.py``) over gloo
ranks on the CPU, held to the JAX package's ``pipeline/spmd.py``.

The JAX twin runs in a subprocess on fake CPU devices (the test process
keeps its one real device), as its own ``tests/test_spmd.py`` runs it, and
saves its loss and grads to an npz; the port runs as spawned gloo ranks of
one thread each (``launch.ranks.run_ranks``, a deadline on every spawn).
Both start from the JAX ``init_pipeline_params`` and the same tokens:
reduced qwen1.5-0.5b in fp32, B 8, s 16, m 4, on the meshes (1, 4) and
(2, 2) under both arms, and at p 3 (3 layers, the odd middle stage mapped
to itself) under ``bpipe_stash``. Bars: loss 1e-5 and grads 1e-5, the JAX
package's own (``tests/test_spmd.py:54,59``).
"""
import concurrent.futures
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_spmd_ranks as R
from repro.configs import get_config
from repro.models.blocks import apply_layer
from repro.models.layers import apply_norm, embed, unembed
from repro.pipeline import spmd as JS
from repro_torch.launch.ranks import RankError, run_ranks
from repro_torch.pipeline import spmd as TS

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
# mesh -> (data, model, layers, the arms the JAX twin runs)
MESHES = {"1x4": (1, 4, 4, ("1f1b", "bpipe")), "2x2": (2, 2, 4, ("1f1b", "bpipe")),
          "1x3": (1, 3, 3, ("bpipe",))}
CASES = [(mesh, arm) for mesh, (_, _, _, arms) in MESHES.items() for arm in arms]
TOL = 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    data, model, layers, arms, out = (int(sys.argv[1]), int(sys.argv[2]),
                                      int(sys.argv[3]), sys.argv[4].split(","),
                                      sys.argv[5])
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={data * model}")
    sys.path.insert(0, %r)
    import dataclasses, jax, numpy as np
    from repro import compat
    from repro.configs import get_config
    from repro.pipeline.spmd import init_pipeline_params, make_spmd_train_loss
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              num_layers=layers, dtype="float32")
    mesh = compat.make_mesh((data, model), ("data", "model"))
    params = init_pipeline_params(jax.random.PRNGKey(0), cfg, model)
    toks = np.load(out + ".tokens.npy")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    res = {}
    with compat.set_mesh(mesh):
        for arm in arms:
            lossf = make_spmd_train_loss(cfg, mesh, model, num_micro=%d,
                                         bpipe_stash=arm == "bpipe")
            loss, g = jax.jit(jax.value_and_grad(lossf))(params, batch)
            res[arm + "/loss"] = np.asarray(loss)
            for i, leaf in enumerate(jax.tree.leaves(g)):
                res[f"{arm}/grad/{i}"] = np.asarray(leaf)
    np.savez(out, **res)
""") % (SRC, R.M)


def _cfg(layers):
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               num_layers=layers, dtype="float32")


def _tokens(cfg):
    toks = jax.random.randint(jax.random.PRNGKey(3), (R.B, R.S + 1), 0,
                              cfg.vocab_size)
    return np.asarray(toks)


def _ref_loss(cfg, p):
    """The JAX package's sequential reference (``tests/test_spmd.py``)."""
    def ref_loss(params, batch):
        x = embed(params["embed"], batch["tokens"], cfg)
        b_, s_ = x.shape[:2]
        pos = jnp.broadcast_to(jnp.arange(s_, dtype=jnp.int32)[None], (b_, s_))
        kinds = cfg.layer_kinds()
        per = cfg.num_layers // p
        for i in range(p):
            for j in range(per):
                lp = jax.tree.map(lambda a: a[i], params["stages"][j])
                x, _ = apply_layer(lp, x, cfg, kinds[j], pos)
        x = apply_norm(params["final_norm"], x)
        logits = unembed(params["embed"], x, cfg)
        lbl = batch["labels"]
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        nll = -jnp.take_along_axis(logp, jnp.maximum(lbl, 0)[..., None], -1)[..., 0]
        return jnp.mean(nll)
    return ref_loss


@functools.lru_cache(maxsize=None)
def _run(mesh, tmp=None):
    """One mesh: the JAX twin in a subprocess, the port's ranks meanwhile,
    and the JAX sequential reference in this process meanwhile too."""
    data, model, layers, arms = MESHES[mesh]
    cfg = _cfg(layers)
    params = JS.init_pipeline_params(jax.random.PRNGKey(0), cfg, model)
    np_params = jax.tree.map(np.asarray, params)
    tokens = _tokens(cfg)
    out = os.path.join(tmp, f"spmd_{mesh}")
    np.save(out + ".tokens.npy", tokens)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(data), str(model), str(layers),
         ",".join(arms), out], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, R.parity_rank, data * model,
                                timeout_s=90,
                                args=(data, model, layers, np_params, tokens))
            loss, grads = jax.jit(jax.value_and_grad(_ref_loss(cfg, model)))(
                params, batch)
            seq = (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)])
            ranks = ranks.result()
        log, _ = jax_proc.communicate(timeout=120)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, log
    got = np.load(out + ".npz")
    jax_spmd = {arm: (float(got[arm + "/loss"]),
                      [got[f"{arm}/grad/{i}"] for i in range(len(seq[1]))])
                for arm in arms}
    return {"ranks": ranks, "jax": jax_spmd, "seq": seq,
            "n_stage_leaves": len(jax.tree.leaves(params["stages"]))}


@pytest.fixture(scope="module")
def spmd_tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("spmd"))


def _check(run, arm, want_loss, want_grads, mesh):
    """Every rank's loss and grads against the JAX (loss, stacked grads):
    a stage leaf (leading dim p) at this rank's stage, a replicated leaf
    whole."""
    n_rep = len(want_grads) - run["n_stage_leaves"]
    for r in run["ranks"]:
        got = r["arms"][arm]
        assert abs(got["loss"] - want_loss) < TOL, (mesh, arm, r["stage"],
                                                    got["loss"], want_loss)
        for i, (g, w) in enumerate(zip(got["grads"], want_grads)):
            w = w if i < n_rep else w[r["stage"]]
            assert g.shape == w.shape, (i, g.shape, w.shape)
            err = float(np.max(np.abs(g - w)))
            assert err < TOL, (mesh, arm, r["stage"], r["data"], i, err)


@pytest.mark.parametrize("mesh,arm", CASES)
def test_spmd_loss_and_grads_equal_jax_spmd(mesh, arm, spmd_tmp):
    run = _run(mesh, spmd_tmp)
    _check(run, arm, *run["jax"][arm], mesh)


@pytest.mark.parametrize("mesh,arm", CASES)
def test_spmd_loss_and_grads_equal_jax_sequential_reference(mesh, arm, spmd_tmp):
    run = _run(mesh, spmd_tmp)
    _check(run, arm, *run["seq"], mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bpipe_stash_adds_one_evict_and_one_load_per_tick(mesh, spmd_tmp):
    """T = m + p - 1 ticks: 2T - 1 shifts (T forward, T - 1 backward: the
    last tick's shift has no reader), and under bpipe_stash one EVICT and
    one LOAD more each tick, on every rank, each of mb x s x d fp32."""
    data, model, _, _ = MESHES[mesh]
    run = _run(mesh, spmd_tmp)
    ticks = R.M + model - 1
    hop = (R.B // data // R.M) * R.S * _cfg(1).d_model * 4
    for r in run["ranks"]:
        plain = r["arms"]["1f1b"]["counter"]
        bp = r["arms"]["bpipe"]["counter"]
        assert plain["ops"]["collective-permute"] == 2 * ticks - 1
        assert bp["ops"]["collective-permute"] - plain["ops"]["collective-permute"] \
            == 2 * ticks
        assert plain["bytes"]["collective-permute"] == (2 * ticks - 1) * hop
        assert bp["bytes"]["collective-permute"] == (4 * ticks - 1) * hop
        assert bp["ops"]["all-reduce"] == plain["ops"]["all-reduce"]


def test_remote_remat_grads_equal_the_plain_stage_fn():
    """The twin of ``tests/test_spmd.py:128-176`` on 4 gloo ranks: grads
    with the remote stash equal the plain stage function's at 1e-6, and the
    stash costs exactly its EVICT and its LOAD."""
    for r in run_ranks(R.remat_rank, 4, timeout_s=60):
        for a, b in zip(r["plain"]["grads"], r["remat"]["grads"]):
            assert float(np.max(np.abs(a - b))) < 1e-6
        assert r["plain"]["hops"] == 0 and r["remat"]["hops"] == 2


@pytest.mark.parametrize("p", [2, 3, 4, 5, 8])
def test_bpipe_perms_equal_jax(p):
    assert TS._bpipe_perms(p) == JS._bpipe_perms(p)


def test_a_rank_that_never_sends_fails_within_its_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks(R.silent_rank, 2, timeout_s=10)
    assert time.monotonic() - t0 < 25


def test_a_rank_that_raises_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 2 gives up"):
        run_ranks(R.failing_rank, 4, timeout_s=60)
    assert time.monotonic() - t0 < 40


def test_init_pipeline_params_builds_its_own_stage():
    """Each rank's stage has the JAX twin's per-stage shapes; embed and
    final_norm are the same on every rank, the layers differ by stage, and
    a generator of the same seed draws them again."""
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import get_config as tget
    cfg = _cfg(4)
    tcfg = dataclasses.replace(tget("qwen1.5-0.5b").reduced(), num_layers=4,
                               dtype="float32")
    want = JS.init_pipeline_params(jax.random.PRNGKey(0), cfg, 2)
    stages = [TS.init_pipeline_params(torch.Generator().manual_seed(5), tcfg, 2,
                                      i, "cpu") for i in range(2)]
    again = TS.init_pipeline_params(torch.Generator().manual_seed(5), tcfg, 2, 1,
                                    "cpu")
    assert len(stages[0]["stages"]) == len(want["stages"]) == 2
    for j, layer in enumerate(want["stages"]):
        shapes = [tuple(a.shape[1:]) for a in jax.tree.leaves(layer)]
        assert [tuple(t.shape) for t in T.leaves(stages[0]["stages"][j])] == shapes
    for key in ("embed", "final_norm"):
        assert all(torch.equal(a, b) for a, b in zip(T.leaves(stages[0][key]),
                                                     T.leaves(stages[1][key])))
    w0, w1 = (T.leaves(s["stages"]) for s in stages)
    assert any(not torch.equal(a, b) for a, b in zip(w0, w1))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(again), T.leaves(stages[1])))


def test_from_jax_pipeline_params_takes_the_stage_slice():
    from repro_torch import tree as T
    cfg = _cfg(4)
    params = jax.tree.map(np.asarray,
                          JS.init_pipeline_params(jax.random.PRNGKey(0), cfg, 4))
    for stage in range(4):
        got = TS.from_jax_pipeline_params(params, stage, "cpu")
        want = [a[stage] for a in jax.tree.leaves(params["stages"])]
        assert all(np.array_equal(g.numpy(), w)
                   for g, w in zip(T.leaves(got["stages"]), want))
        assert np.array_equal(got["embed"]["table"].numpy(), params["embed"]["table"])
