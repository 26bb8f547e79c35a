"""The sequence-sliced path of repro_torch against the JAX package's, on the
CPU: ``attention_sliced`` (the flash arm against the Pallas kernel in
interpret mode, and the ``_sdpa`` arm), ``apply_layer_sliced`` and
``make_sliced_stage_fn`` on the first, an interior and the last stage.

Reduced qwen1.5-0.5b, 4 layers, fp32, seq 8 cut into two slices of 4.
Params come from ``repro.models.model.init_params`` through the bridge,
inputs and cotangents from numpy seeds. Each check holds the forward
outputs (and the slice's own KV) and the grads with respect to the params,
the carry and the KV prefix, at the executor tests' tolerances: 1e-5 on
values, atol 2e-6 / rtol 1e-4 on grads. Those tolerances were set for the
grads of a mean loss, so the cotangents here have the size the executor
feeds a stage of this model at m 4 (``COT``; it measures std 3e-4 to 2.5e-3
on the activation and KV cotangents of a 1f1b c 2 step of
``tests/test_torch_executor.py``'s batch), and the last stage's are the
executor's own, ``(scale / count, scale)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import RGLRU
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import model as JM
from repro.pipeline import stage as JS
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as TA
from repro_torch.models import blocks as TB
from repro_torch.pipeline import stage as TS

VAL_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-6, 1e-4
L, P_LEN = 4, 4          # slice length; the prefix of the second slice
COT = 2e-3               # std of a cotangent the executor feeds a stage
M, SEQ = 4, 2 * L        # the executor's microbatches and sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(impl="reference"):
    over = dict(num_layers=4, dtype="float32", attn_impl=impl)
    return (dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), **over),
            dataclasses.replace(tget_config("qwen1.5-0.5b").reduced(), **over))


_PARAMS = {}


def _params():
    if not _PARAMS:
        jc, _ = _cfgs()
        p = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc))
        _PARAMS.update(np=p, jax=jax.tree.map(jnp.asarray, p),
                       torch=bridge.to_torch(p, device="cpu"))
    return _PARAMS


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(t, j, atol=VAL_TOL, rtol=0.0):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


def _close_grads(tgrads, jgrads):
    assert len(tgrads) == len(jgrads)
    for t, j in zip(tgrads, jgrads):
        _close(t, j, atol=GRAD_ATOL, rtol=GRAD_RTOL)


def _prefix(rng, cfg, plen, b=2):
    shape = (b, plen, cfg.num_kv_heads, cfg.head_dim)
    return _rand(rng, shape), _rand(rng, shape)


def _positions(b, plen):
    return np.broadcast_to(np.arange(plen, plen + L, dtype=np.int32), (b, L))


@pytest.mark.parametrize("plen", [0, P_LEN])
@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_attention_sliced_matches_jax(impl, plen):
    jc, tc = _cfgs(impl)
    b = 2
    rng = np.random.default_rng(10 + plen)
    layer = _params()["np"]["blocks"]["pos0"]
    p = jax.tree.map(lambda a: a[1], layer["mixer"])
    x = _rand(rng, (b, L, jc.d_model))
    pk, pv = _prefix(rng, jc, plen, b)
    pos = _positions(b, plen)
    kv_shape = pk.shape[:1] + (L,) + pk.shape[2:]
    cot = (_rand(rng, (b, L, jc.d_model), COT),
           (_rand(rng, kv_shape, COT), _rand(rng, kv_shape, COT)))

    def jfn(p_, x_, pk_, pv_):
        return JA.attention_sliced(p_, x_, jc, jnp.asarray(pos), (pk_, pv_),
                                   kind="attn")

    want, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                        jnp.asarray(pk), jnp.asarray(pv))
    jgrads = vjp(jax.tree.map(jnp.asarray, cot))

    tp = T.tree_map(lambda a: a.requires_grad_(True),
                    bridge.to_torch(p, device="cpu"))
    tx, tpk, tpv = _leaf(x), _leaf(pk), _leaf(pv)
    got = TA.attention_sliced(tp, tx, tc, torch.from_numpy(pos.copy()),
                              (tpk, tpv), kind="attn")
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        _close(g, w)
    tcot = [torch.from_numpy(c) for c in (cot[0], *cot[1])]
    leaves = T.leaves(tp) + [tx, tpk, tpv]
    tgrads = torch.autograd.grad([got[0], *got[1]], leaves, tcot)
    _close_grads(tgrads, jax.tree.leaves(jgrads[0]) + list(jgrads[1:]))


@pytest.mark.parametrize("remat", ["none", "attn"])
def test_apply_layer_sliced_matches_jax(remat):
    jc, tc = _cfgs()
    b = 2
    rng = np.random.default_rng(20)
    p = jax.tree.map(lambda a: a[2], _params()["np"]["blocks"]["pos0"])
    x = _rand(rng, (b, L, jc.d_model))
    pk, pv = _prefix(rng, jc, P_LEN, b)
    pos = _positions(b, P_LEN)
    kv_shape = pk.shape[:1] + (L,) + pk.shape[2:]
    cot = (_rand(rng, (b, L, jc.d_model), COT),
           (_rand(rng, kv_shape, COT), _rand(rng, kv_shape, COT)))

    def jfn(p_, x_, pk_, pv_):
        y, _, kv = JB.apply_layer_sliced(p_, x_, jc, "attn", jnp.asarray(pos),
                                         (pk_, pv_), remat=remat)
        return y, kv

    want, vjp = jax.vjp(jfn, jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                        jnp.asarray(pk), jnp.asarray(pv))
    jgrads = vjp(jax.tree.map(jnp.asarray, cot))

    tp = T.tree_map(lambda a: a.requires_grad_(True),
                    bridge.to_torch(p, device="cpu"))
    tx, tpk, tpv = _leaf(x), _leaf(pk), _leaf(pv)
    y, aux, (k, v) = TB.apply_layer_sliced(
        tp, tx, tc, "attn", torch.from_numpy(pos.copy()), (tpk, tpv),
        remat=remat)
    assert aux == 0.0
    for g, w in zip((y, k, v), (want[0], *want[1])):
        _close(g, w)
    tgrads = torch.autograd.grad(
        [y, k, v], T.leaves(tp) + [tx, tpk, tpv],
        [torch.from_numpy(c) for c in (cot[0], *cot[1])])
    _close_grads(tgrads, jax.tree.leaves(jgrads[0]) + list(jgrads[1:]))


def test_apply_layer_sliced_refuses_what_cannot_slice():
    _, tc = _cfgs()
    p = {"mixer": {}, "norm1": {}}
    kv = (torch.zeros(1, 0, 1, 1),) * 2
    with pytest.raises(ValueError, match="attention mixers"):
        TB.apply_layer_sliced(p, None, tc, RGLRU, None, kv)
    with pytest.raises(ValueError, match="cross-attention"):
        TB.apply_layer_sliced({**p, "cross": {}}, None, tc, "attn", None, kv)
    assert TB.SLICEABLE_KINDS == JB.SLICEABLE_KINDS


@pytest.mark.parametrize("plen", [0, P_LEN])
@pytest.mark.parametrize("stage", [0, 1, 3], ids=["first", "interior", "last"])
def test_sliced_stage_fn_matches_jax(stage, plen):
    """One slice through a stage of a 4-stage split: its primary output
    ((activation, aux), or (nll_sum, aux) on the last stage) and own KV,
    and the grads of both w.r.t. the stage's params, the carry and the
    prefix."""
    jc, tc = _cfgs()
    b, p = 2, 4
    rng = np.random.default_rng(30 + stage + plen)
    jsp = JS.StageSplitter(jc, p).split(_params()["jax"])[stage]
    tsp = TS.StageSplitter(tc, p).split(_params()["torch"])[stage]
    toks = rng.integers(0, jc.vocab_size, (b, L + 1)).astype(np.int32)
    toks[0, -1] = -1                       # a masked label
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    n_layers = len(JS.layer_assignment(jc, p)[stage])
    prefix = [_prefix(rng, jc, plen, b) for _ in range(n_layers)]
    carry = (_rand(rng, (b, L, jc.d_model)), np.float32(0.25))
    last = stage == p - 1
    kv_shape = (b, L, jc.num_kv_heads, jc.head_dim)
    cot_primary = ((np.float32(1 / M / (b * SEQ)), np.float32(1 / M)) if last
                   else (_rand(rng, (b, L, jc.d_model), COT), np.float32(1 / M)))
    cot_kv = tuple((_rand(rng, kv_shape, COT), _rand(rng, kv_shape, COT))
                   for _ in range(n_layers))

    jfn = JS.make_sliced_stage_fn(jc, p, stage)
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()},
              "offset": jnp.int32(plen)}
    jcarry = (jnp.zeros((b, L, jc.d_model), jnp.float32),
              jnp.zeros((), jnp.float32)) if stage == 0 \
        else tuple(jnp.asarray(c) for c in carry)
    want, vjp = jax.vjp(lambda sp, c, kvp: jfn(sp, c, kvp, jbatch), jsp,
                        jcarry, jax.tree.map(jnp.asarray, tuple(prefix)))
    jd_sp, jd_carry, jd_kvp = vjp(jax.tree.map(jnp.asarray,
                                               (cot_primary, cot_kv)))

    tfn = TS.make_sliced_stage_fn(tc, p, stage)
    tcarry = () if stage == 0 else tuple(_leaf(c) for c in carry)
    tprefix = tuple((_leaf(k), _leaf(v)) for k, v in prefix)
    tbatch = {**{k: torch.from_numpy(v.copy()) for k, v in batch.items()},
              "offset": plen}
    (primary, kv_own) = tfn(tsp, tcarry, tprefix, tbatch)
    outs = list(primary) + [t for kv in kv_own for t in kv]
    assert len(outs) == len(jax.tree.leaves(want))
    for g, w in zip(outs, jax.tree.leaves(want)):
        _close(g, w, rtol=1e-6)
    cots = [torch.tensor(c) for c in cot_primary] + [
        torch.from_numpy(t) for kv in cot_kv for t in kv]
    live = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
    leaves = T.leaves(tsp) + list(tcarry) + [t for kv in tprefix for t in kv]
    tgrads = torch.autograd.grad([o for o, _ in live], leaves,
                                 [c for _, c in live], allow_unused=True)
    tgrads = [torch.zeros_like(t) if g is None else g
              for t, g in zip(leaves, tgrads)]
    jgrads = (jax.tree.leaves(jd_sp)
              + ([] if stage == 0 else list(jd_carry))
              + [t for kv in jd_kvp for t in kv])
    _close_grads(tgrads, jgrads)
