"""repro_torch.models.recurrent vs repro.models.recurrent on the same inputs
(fp32, CPU): each RG-LRU function, values and grads.

Params come from the JAX init through the bridge, inputs from a numpy seed,
seq <= 32. The port's scan is a doubling (Hillis-Steele) scan with its own
backward where the twin takes ``lax.associative_scan``: fp32 on both sides,
the sums taken in another order. Values are held to atol 1e-5 / rtol 1e-4,
grads to atol 1e-5 / rtol 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import recurrent as JR
from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config as tget_config
from repro_torch.models import recurrent as TR

ATOL, RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3


def _cfgs():
    over = dict(dtype="float32")
    return (dataclasses.replace(get_config("recurrentgemma-2b").reduced(), **over),
            dataclasses.replace(tget_config("recurrentgemma-2b").reduced(), **over))


def _params(jc, seed=4):
    p = jax.tree.map(np.asarray, JR.init_rglru_block(jax.random.PRNGKey(seed), jc))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _x(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(t, j, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=rtol)


def _grads_match(jfn, tfn, jp, tp, inputs):
    """Values of fn(p, *inputs) and the grads of sum(fn * c) w.r.t. params
    and inputs (a float output or a tuple of them), JAX against torch."""
    jout = jfn(jp, *map(jnp.asarray, inputs))
    single = not isinstance(jout, tuple)
    jouts = (jout,) if single else jout
    cots = [_x(*np.shape(o), seed=10 + i) for i, o in enumerate(jouts)]

    def jloss(p, *xs):
        out = jfn(p, *xs)
        out = (out,) if single else out
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))

    jg = jax.grad(jloss, argnums=tuple(range(len(inputs) + 1)))(
        jp, *map(jnp.asarray, inputs))
    paths, leaves = zip(*T.leaves_with_paths(tp))
    req = [t.clone().requires_grad_(True) for t in leaves]
    txs = [torch.from_numpy(x).requires_grad_(True) for x in inputs]
    tout = tfn(T.unflatten(paths, req), *txs)
    touts = (tout,) if single else tout
    for t, j in zip(touts, jouts):
        _close(t, j)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots))
    got = torch.autograd.grad(loss, req + txs, allow_unused=True)
    want = dict(T.leaves_with_paths(bridge.to_torch(
        jax.tree.map(np.asarray, jg[0]), device="cpu")))
    for path, g in zip(paths, got[:len(req)]):
        w = want[path].numpy()
        _close(torch.zeros_like(torch.from_numpy(w)) if g is None else g, w,
               rtol=GRAD_RTOL)
    for g, w in zip(got[len(req):], jg[1:]):
        _close(g, w, rtol=GRAD_RTOL)


def test_init_shapes_match():
    jc, tc = _cfgs()
    jp, _ = _params(jc)
    tp = TR.init_rglru_block(torch.Generator().manual_seed(0), tc, "cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    a = torch.sigmoid(tp["lam"]) ** 8   # the init's decay range
    assert bool(((a > 0.0) & (a < 1.0)).all())


def test_gates_match():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, 12, tc.rnn_width)
    _grads_match(JR._gates, TR._gates, jp, tp, [x])


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` has no cut-off at 20, where ``F.softplus`` has."""
    x = np.array([-30.0, -1.0, 0.0, 19.5, 20.5, 40.0], np.float32)
    _close(TR._softplus(torch.from_numpy(x)), jax.nn.softplus(jnp.asarray(x)))


@pytest.mark.parametrize("s", [1, 2, 5, 16, 32])
def test_rglru_scan_matches(s):
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, s, tc.rnn_width, seed=s)
    _grads_match(JR.rglru_scan, TR.rglru_scan, jp, tp, [x])


@pytest.mark.parametrize("s", [1, 3, 8, 17, 32])
def test_linear_scan_equals_the_recurrence(s):
    """The doubling scan and its backward against a plain loop over time
    steps through autograd."""
    a0 = torch.from_numpy(np.random.default_rng(s).uniform(
        0.5, 1.0, (2, s, 6)).astype(np.float32))
    x0 = torch.from_numpy(_x(2, s, 6, seed=s + 1))
    g = torch.from_numpy(_x(2, s, 6, seed=s + 2))
    outs = []
    for fn in (TR.linear_scan, None):
        a, x = a0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
        if fn is None:
            h, hs = torch.zeros(2, 6), []
            for t in range(s):
                h = a[:, t] * h + x[:, t]
                hs.append(h)
            h = torch.stack(hs, 1)
        else:
            h = fn(a, x)
        outs.append((h, *torch.autograd.grad(h, (a, x), g)))
    for got, want in zip(*outs):
        _close(got, want.detach().numpy())


def test_rglru_step_matches_and_equals_scan():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(3, 6, tc.rnn_width)
    h0 = _x(3, tc.rnn_width, seed=5)
    _grads_match(JR.rglru_step, TR.rglru_step, jp, tp, [x[:, 0], h0])
    # stepping through the sequence from 0 gives the scan's states
    h = torch.zeros(3, tc.rnn_width)
    scan = TR.rglru_scan(tp, torch.from_numpy(x))
    for t in range(x.shape[1]):
        out, h = TR.rglru_step(tp, torch.from_numpy(x[:, t]), h)
        _close(out, scan[:, t].numpy())


def test_conv_full_matches():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, 9, tc.rnn_width)
    _grads_match(JR._conv_full, TR._conv_full, jp, tp, [x])


def test_conv_step_matches():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, tc.rnn_width)
    st = _x(2, tc.conv_width - 1, tc.rnn_width, seed=3)
    _grads_match(JR._conv_step, TR._conv_step, jp, tp, [x, st])


def test_init_rglru_state_matches():
    jc, tc = _cfgs()
    for dtype, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = JR.init_rglru_state(jc, 3, dtype)
        got = TR.init_rglru_state(tc, 3, tdt, "cpu")
        for k in want:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name
            assert not bool(got[k].any())


def test_apply_rglru_block_matches():
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, 24, tc.d_model)
    _grads_match(lambda p, xx: JR.apply_rglru_block(p, xx, jc),
                 lambda p, xx: TR.apply_rglru_block(p, xx, tc), jp, tp, [x])


def test_apply_rglru_block_step_matches():
    """One decode step from a nonzero state: output, new h and conv tail,
    values and grads; the port writes the new state into the given one."""
    jc, tc = _cfgs()
    jp, tp = _params(jc)
    x = _x(2, 1, tc.d_model)
    h0 = _x(2, tc.rnn_width, seed=7)
    conv0 = _x(2, tc.conv_width - 1, tc.rnn_width, seed=8)

    def jfn(p, xx, h, conv):
        out, st = JR.apply_rglru_block_step(p, xx, jc, {"h": h, "conv": conv})
        return out, st["h"], st["conv"]

    def tfn(p, xx, h, conv):
        st = {"h": h.clone(), "conv": conv.clone()}
        out, st2 = TR.apply_rglru_block_step(p, xx, tc, st)
        assert st2 is st          # written in place, grads through the writes
        return out, st["h"], st["conv"]

    _grads_match(jfn, tfn, jp, tp, [x, h0, conv0])
