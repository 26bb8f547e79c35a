"""repro_torch.models.moe vs repro.models.moe on the same inputs (fp32, CPU).

Params come from the JAX init through the bridge, inputs from a numpy seed.
The router runs on fp32 random inputs, where no two probabilities tie, so
``torch.topk`` and ``lax.top_k`` pick the same experts in the same order.
Values are held to atol 1e-5 / rtol 1e-4, grads to atol 1e-5 / rtol 1e-3
(the bound of the MoE executor test, tests/test_executor.py): fp32 on both
sides, differing in the order of the sums (the expert products, the gate
combine, the router's softmax; the router's grad sums over every token).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import moe as JMoE
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMoE

ATOL, RTOL = 1e-5, 1e-4
GRAD_RTOL = 1e-3
ARCHS = ["granite-moe-1b-a400m",      # 4 experts top 2 at smoke scale
         "llama4-scout-17b-a16e"]     # top 1 + the shared expert


def _cfgs(arch, capacity_factor=None, **kw):
    j = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)
    t = dataclasses.replace(tget_config(arch).reduced(), dtype="float32", **kw)
    if capacity_factor is not None:
        j = dataclasses.replace(j, moe=dataclasses.replace(
            j.moe, capacity_factor=capacity_factor))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, capacity_factor=capacity_factor))
    return j, t


def _params(jc):
    p = jax.tree.map(np.asarray, JMoE.init_moe(jax.random.PRNGKey(3), jc))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _x(b, s, d, seed=0):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq_len", [1, 7, 16, 32, 2048])
def test_capacity_matches(arch, seq_len):
    for cf in (None, 1.0, 1.25, 4.0):
        jc, tc = _cfgs(arch, capacity_factor=cf)
        assert TMoE.capacity(tc, seq_len) == JMoE.capacity(jc, seq_len)
    jc, tc = (get_config(arch), tget_config(arch))   # full-size configs
    assert TMoE.capacity(tc, seq_len) == JMoE.capacity(jc, seq_len)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, "num_experts"])
def test_route_matches(arch, capacity_factor):
    """Gates, expert ids and the Switch aux, with the config's capacity
    factor (1.25: drops) and without drops (capacity = every choice)."""
    jc, _ = _cfgs(arch)
    cf = float(jc.moe.num_experts) if capacity_factor else None
    jc, tc = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jc)
    x = _x(2, 16, jc.d_model)
    jg, ji, ja = JMoE.route(jp, jnp.asarray(x), jc)
    tg, ti, ta = TMoE.route(tp, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tg, jg)
    _close(ta, ja)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, "num_experts"])
def test_apply_moe_values_and_grads(arch, capacity_factor):
    """y, aux and the grads of sum(y * c) + aux w.r.t. params and x, with
    and without drops (with: some choices reach the drop bin)."""
    jc, _ = _cfgs(arch)
    cf = float(jc.moe.num_experts) if capacity_factor else None
    jc, tc = _cfgs(arch, capacity_factor=cf)
    jp, tp = _params(jc)
    b, s = 2, 32
    x = _x(b, s, jc.d_model, seed=1)
    cot = _x(b, s, jc.d_model, seed=2)
    if capacity_factor is None:
        _, idx, _ = JMoE.route(jp, jnp.asarray(x), jc)
        per_expert = np.stack([np.bincount(np.asarray(idx)[r].ravel(),
                                           minlength=jc.moe.num_experts)
                               for r in range(b)])
        assert per_expert.max() > JMoE.capacity(jc, s)   # drops happen

    def jloss(p, xx):
        y, aux = JMoE.apply_moe(p, xx, jc)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    paths, leaves = zip(*T.leaves_with_paths(tp))
    req = [t.clone().requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TMoE.apply_moe(T.unflatten(paths, req), tx, tc)
    grads = torch.autograd.grad((ty * torch.from_numpy(cot)).sum() + taux,
                                req + [tx])
    _close(ty, jy)
    _close(taux, jaux)
    _close(grads[-1], jgx, rtol=GRAD_RTOL)
    want = dict(T.leaves_with_paths(bridge.to_torch(
        jax.tree.map(np.asarray, jgp), device="cpu")))
    for path, g in zip(paths, grads[:-1]):
        _close(g, want[path].numpy(), rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_constrained_matches(arch):
    """``moe_constrained`` outside a mesh: the reference's constraints do
    nothing there, and the port's neither (``sharding.rules.maybe_constrain``),
    so y, aux and the grads equal the reference's with the flag."""
    jc, tc = _cfgs(arch, moe_constrained=True)
    jp, tp = _params(jc)
    x, cot = _x(2, 32, jc.d_model, seed=1), _x(2, 32, jc.d_model, seed=2)

    def jloss(p, xx):
        y, aux = JMoE.apply_moe(p, xx, jc)
        return jnp.sum(y * cot) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    paths, leaves = zip(*T.leaves_with_paths(tp))
    req = [t.clone().requires_grad_(True) for t in leaves]
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = TMoE.apply_moe(T.unflatten(paths, req), tx, tc)
    grads = torch.autograd.grad((ty * torch.from_numpy(cot)).sum() + taux,
                                req + [tx])
    _close(ty, jy)
    _close(taux, jaux)
    _close(grads[-1], jgx, rtol=GRAD_RTOL)
    want = dict(T.leaves_with_paths(bridge.to_torch(
        jax.tree.map(np.asarray, jgp), device="cpu")))
    for path, g in zip(paths, grads[:-1]):
        _close(g, want[path].numpy(), rtol=GRAD_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_bmm_matches_plain_product(dtype):
    """``cast_bmm`` gives bmm(x, w.to(x.dtype))'s values and grads bit for
    bit, and saves the fp32 weight rather than its cast copy."""
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((3, 10, 8)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 10, 6)).astype(np.float32))
    outs = []
    for fn in (TL.cast_bmm, lambda x, w: torch.bmm(x, w.to(x.dtype))):
        x = x0.to(dtype).requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            y = fn(x, w)
        outs.append((y, *torch.autograd.grad(y, (x, w), g.to(dtype)), saved))
    (y, gx, gw, saved), (y2, gx2, gw2, _) = outs
    assert torch.equal(y, y2) and torch.equal(gx, gx2) and torch.equal(gw, gw2)
    assert gw.dtype == torch.float32
    # cast_bmm saves the fp32 weight, never a cast copy of it
    assert not any(t.shape == w0.shape and t.dtype != torch.float32
                   for t in saved)
