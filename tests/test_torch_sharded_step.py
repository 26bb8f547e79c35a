"""The port's sharded train step (``make_train_step(cfg, tcfg, mesh=)``) on
four gloo CPU ranks against the JAX package's single-device step on the
same params (through ``repro_torch.bridge``) and batch, fp32.

Meshes (1, 4), (2, 2) and (4, 1); reduced llama-65b and gpt3-96b with both
attention arms, and reduced granite-moe-1b-a400m with ``moe_constrained``
on (2, 2). Bars: the loss within 1e-5, each grad leaf within atol 2e-6 /
rtol 1e-4 (the executor's, ``tests/test_executor.py:34-37``), each updated
param leaf within 1e-5. A spawn of four ranks runs one case on one mesh
(``tests/_torch_sharded_ranks.py``); the ranks' collectives of
CPU tensors go through ``launch/staged.py``'s kernels, registered for the
CPU, so the staged transport the card uses is the one these tests hold.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import model as JM
from repro.optim import adam as JA
from repro.train import steps as JS
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.launch.ranks import run_ranks

import _torch_sharded_ranks as R

MESHES = [(1, 4), (2, 2), (4, 1)]
CASES = [(a, i) for a in ("llama-65b", "gpt3-96b") for i in ("flash", "reference")]
MOE = ("granite-moe-1b-a400m", "flash", {"moe_constrained": True})
B, S = 4, 16


def _jcfg(arch, impl, **over):
    import dataclasses
    from repro.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               attn_impl=impl, **over)


@functools.lru_cache(maxsize=None)
def _inputs(arch, impl, over=()):
    """JAX params (numpy) and tokens (B, S + 1)."""
    cfg = _jcfg(arch, impl, **dict(over))
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return params, tokens


def _want(arch, impl, over=()):
    """The JAX step's loss, grads and updated params: ``make_loss_grad``
    then ``adam.update``, the body of its ``make_train_step``."""
    cfg = _jcfg(arch, impl, **dict(over))
    params, tokens = _inputs(arch, impl, over)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    tcfg = JTrainConfig(global_batch=B, seq_len=S, remat="none")

    @jax.jit
    def step(params):
        loss, grads = JS.make_loss_grad(cfg, tcfg)(params, batch)
        return loss, grads, JA.update(params, grads, JA.init(params), tcfg)[0]

    loss, grads, new = step(params)
    flat = lambda t: dict(T.leaves_with_paths(jax.tree.map(np.asarray, t)))
    return float(loss), flat(grads), flat(new)


@functools.lru_cache(maxsize=None)
def _ranks(data, model, arch, impl, over=()):
    """One spawn of four ranks a case (each test under half a minute)."""
    import pickle
    import tempfile
    cases = {"case": (arch, impl, dict(over), *_inputs(arch, impl, over))}
    with tempfile.NamedTemporaryFile(suffix=".pkl") as f:
        pickle.dump(cases, f)
        f.flush()
        return run_ranks(R.parity_rank, 4, args=(data, model, f.name),
                         timeout_s=120, staged_key="CPU")


def _check(ranks, name, want):
    loss, grads, params = want
    got = ranks[0][name]
    assert all(abs(r[name]["loss"] - loss) <= 1e-5 for r in ranks), (
        [r[name]["loss"] for r in ranks], loss)
    assert set(got["grads"]) == set(grads)
    for path, g in got["grads"].items():
        np.testing.assert_allclose(g, grads[path], atol=2e-6, rtol=1e-4,
                                   err_msg=str(path))
    for path, p in got["params"].items():
        assert np.abs(p - params[path]).max() <= 1e-5, path


@pytest.mark.parametrize("case", CASES, ids=["-".join(c) for c in CASES])
@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_sharded_step_matches_jax(mesh, case):
    _check(_ranks(*mesh, *case), "case", _want(*case))


def test_moe_constrained_sharded_step_matches_jax():
    a, i, over = MOE
    over = tuple(over.items())
    _check(_ranks(2, 2, a, i, over), "case", _want(a, i, over))


def test_staged_collectives_counted_on_every_mesh():
    """Every mesh's step moved bytes through the staged kernels: (1, 4) and
    (2, 2) all-reduce the tensor-parallel partial sums, (4, 1) and (2, 2)
    the replicated params' grads over "data"."""
    for mesh in MESHES:
        for r in _ranks(*mesh, "llama-65b", "flash"):
            c = r["case"]["counter"]
            assert c["ops"]["all-reduce"] > 0 and c["bytes"]["all-reduce"] > 0, mesh


def test_sharded_step_refuses_wrong_placements():
    params, tokens = _inputs("llama-65b", "flash")
    got = run_ranks(R.refusal_rank, 4, args=(params, tokens), timeout_s=90)
    assert got == [["TypeError", "ValueError"]] * 4
