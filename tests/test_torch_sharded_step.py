"""The port's sharded train step (``make_train_step(cfg, tcfg, mesh=)``) on
four gloo CPU ranks against the JAX package's single-device step on the
same params (through ``repro_torch.bridge``) and batch, fp32.

Meshes (1, 4), (2, 2) and (4, 1); reduced llama-65b and gpt3-96b with both
attention arms, reduced granite-moe-1b-a400m with ``moe_constrained``
on (2, 2), and ``HAZARDS``: dims that 4 ranks do not divide, the MoE
unconstrained and whisper-small. The dry run's gradient accumulation is
held to the single-shot step on the same ranks. Bars: the loss within 1e-5, each grad leaf within atol 2e-6 /
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
B, S, FRAMES = 4, 16, 8
# (mesh, arch, attention arm, config overrides): dims that 4 "model" ranks do
# not divide (2 mLSTM/sLSTM heads; an odd tied vocab, 509, with the MoE
# dispatch unconstrained), the MoE unconstrained on both axes, and the
# encoder-decoder with its frames
HAZARDS = [((1, 4), "xlstm-125m", "flash",
            (("num_heads", 2), ("num_kv_heads", 2), ("head_dim", 128))),
           ((1, 4), "granite-moe-1b-a400m", "flash", (("vocab_size", 509),)),
           ((2, 2), "granite-moe-1b-a400m", "reference", ()),
           ((1, 4), "whisper-small", "flash", ())]


def _jcfg(arch, impl, **over):
    import dataclasses
    from repro.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               attn_impl=impl, **over)


@functools.lru_cache(maxsize=None)
def _inputs(arch, impl, over=()):
    """JAX params (numpy) and the batch (numpy): tokens and labels (B, S)
    from one draw of (B, S + 1) tokens, and an encoder-decoder's
    ``enc_embeds`` (B, FRAMES, d) from the same seed."""
    cfg = _jcfg(arch, impl, **dict(over))
    params = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    return params, batch


def _want(arch, impl, over=()):
    """The JAX step's loss, grads and updated params: ``make_loss_grad``
    then ``adam.update``, the body of its ``make_train_step``."""
    cfg = _jcfg(arch, impl, **dict(over))
    params, batch = _inputs(arch, impl, over)
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


@pytest.mark.parametrize("mesh,arch,impl,over", HAZARDS, ids=[
    f"{a}-{i}-{d}x{m}" + "".join(f"-{k}{v}" for k, v in o)
    for (d, m), a, i, o in HAZARDS])
def test_sharded_step_hazards_match_jax(mesh, arch, impl, over):
    """The dims the production meshes leave uneven, on four ranks: the
    mLSTM's recurrence and the sLSTM's loop on local rows where 2 heads do
    not divide 4 (relocated onto head_dim), the cross-entropy on the local
    vocab of a tied table whose 509 rows 4 ranks do not divide (relocated
    onto d), the MoE's row-local dispatch without ``moe_constrained``, and
    whisper-small's encoder, decoder and cross attention, each against the
    JAX step at the executor's tolerances."""
    _check(_ranks(*mesh, arch, impl, over), "case", _want(arch, impl, over))


def test_accumulated_grads_match_the_single_shot_step():
    """The dry run's gradient accumulation (``dryrun.accumulated_grads``)
    on a (2, 2) mesh against the single-shot step of the same batch: 2
    microbatches of 2 rows (a plain shard over "data": each rank's rows
    0::2 and 1::2) and 4 of 1 row (which 2 data ranks do not divide: the
    batch relocated onto the sequence, each microbatch whole on every data
    rank); the loss within 1e-5, each grad leaf within 2e-6 + 1e-4 |want|."""
    params, batch = _inputs("llama-65b", "flash")
    got = run_ranks(R.accum_rank, 4, args=(params, batch, (2, 4)), timeout_s=180,
                    staged_key="CPU")
    for r in got:
        for n, res in r.items():
            assert abs(res["loss"] - r["single"]["loss"]) <= 1e-5, (n, res["loss"])
    for n in (2, 4):
        want, g = got[0]["single"]["grads"], got[0][n]["grads"]
        assert set(g) == set(want)
        for path, x in g.items():
            np.testing.assert_allclose(x, want[path], atol=2e-6, rtol=1e-4,
                                       err_msg=f"{n} microbatches {path}")
    # the relocated split moved the batch once, the plain one nothing
    assert got[0][2]["moves"] == [] and got[0][4]["moves"]


def test_gqa_q_heads_over_ranks_match_the_whole_attention():
    """2 batch rows and 2 kv heads that 4 "model" ranks do not divide, 8 q
    heads that they do: each rank takes 2 q heads, which lie in one kv
    group, and that kv head (k and v gathered over "model", their grads
    summed there), for ``_sdpa`` and ``_flash``; values and grads within
    1e-6 of the attention on the whole tensors."""
    got = run_ranks(R.gqa_rank, 4, args=(0,), timeout_s=90, staged_key="CPU")
    for r in got:
        for name, res in r.items():
            assert res["placements"] == ["S(0)", "S(2)"], name
            assert res["moves"] == ["attn_kv"], name
            assert res["err"] <= 1e-6 * max(1.0, res["scale"]), (name, res)


def test_rope_on_dtensors_runs_on_local_rows():
    """``attention._rope`` hands ``rope_qk`` plain local tensors and the
    rows of the positions that go with them: q and k keep batch, sequence
    and head shards as they are, and a head_dim shard of k takes the kv
    placements of ``_flash``; values and grads within 1e-6 of rope_qk on
    the whole tensors."""
    got = run_ranks(R.rope_rank, 4, args=(0,), timeout_s=90, staged_key="CPU")
    want = {"rows": (["S(0)", "S(2)"], []), "sequence": (["S(1)", "S(2)"], []),
            "head_dim": (["S(0)", "S(2)"], ["attn_kv"])}
    for r in got:
        assert set(r) == set(want)
        for name, res in r.items():
            assert res["placements"] == [want[name][0]] * 2, name
            assert res["moves"] == want[name][1], name
            assert res["seen"] == ["Tensor"], name
            assert res["err"] <= 1e-6 * max(1.0, res["scale"]), (name, res)


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
    params, batch = _inputs("llama-65b", "flash")
    got = run_ranks(R.refusal_rank, 4, args=(params, batch), timeout_s=90)
    assert got == [["TypeError", "ValueError"]] * 4
