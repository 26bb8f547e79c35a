"""The xLSTM cells of the port (``repro_torch/models/xlstm.py``) against the
JAX package's (``repro/models/xlstm.py``), one function at a time, at
reduced xlstm-125m in fp32 (d 256, 4 heads of 64, chunk 16).

Params come from the JAX inits through the bridge, inputs from numpy
seeds. Bounds as the reference's own tests (tests/test_models.py:115-131):
the mLSTM 2e-4 / 1e-3, the sLSTM 1e-5 / 1e-4. Grads are of the sum of the
block's output times a fixed random cotangent. The sLSTM's are held to its
values' bars. The mLSTM's reach |grad| in the hundreds (large h, small
denominators), where fp32 sums in another order differ by more than 2e-4,
so each mLSTM leaf is held to 1e-3 |want| + 1e-4 max |want| (the scale of
the card checks' ``grad_agree``). s 33 with chunk 16 takes the pad path,
whose steps carry li = -inf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import xlstm as JX
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import xlstm as TX

M_ATOL, M_RTOL = 2e-4, 1e-3
M_GRAD_SCALE = 1e-4  # of the leaf's max |want|
S_ATOL, S_RTOL = 1e-5, 1e-4
JC = dataclasses.replace(get_config("xlstm-125m").reduced(), dtype="float32")
TC = dataclasses.replace(tget_config("xlstm-125m").reduced(), dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny CPU ops gain nothing from intra-op threads (see
    tests/test_torch_executor.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _params(init, seed=0):
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), JC))
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _x(s, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, JC.d_model)).astype(np.float32)


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _states_close(got, want, atol, rtol):
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], atol, rtol)


def _grad_close(got, want):
    """An mLSTM grad leaf within M_RTOL |want| + M_GRAD_SCALE max |want|."""
    want = np.asarray(want)
    _close(got, want, M_GRAD_SCALE * np.abs(want).max(), M_RTOL)


def _grads(jfn, tfn, jp, tp, x, seed):
    """Grads w.r.t. params and x of sum(block(p, x) * ct), both packages."""
    ct = np.random.default_rng(100 + seed).standard_normal(
        x.shape).astype(np.float32)
    jg = jax.grad(lambda p, x: jnp.sum(jfn(p, x, JC) * ct),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    req = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    (tfn(req, xt, TC) * torch.from_numpy(ct)).sum().backward()
    return jg, ({k: v.grad for k, v in req.items()}, xt.grad)


@pytest.mark.parametrize("s", [16, 24, 33, 64])
def test_mlstm_chunkwise_matches_jax(s):
    """h and the end state, then grads w.r.t. every param and x through
    ``apply_mlstm_block``: all finite (the pad steps' -inf gates), within
    1e-3 |want| + 1e-4 max |want| of ``jax.grad``."""
    jp, tp = _params(JX.init_mlstm)
    x = _x(s, seed=s)
    jh, jst = JX.mlstm_chunkwise(jp, jnp.asarray(x), JC)
    th, tst = TX.mlstm_chunkwise(tp, torch.from_numpy(x), TC)
    _close(th, jh, M_ATOL, M_RTOL)
    _states_close(tst, jst, M_ATOL, M_RTOL)
    (jgp, jgx), (tgp, tgx) = _grads(JX.apply_mlstm_block, TX.apply_mlstm_block,
                                    jp, tp, x, s)
    assert tgp.keys() == jgp.keys()
    for k in jgp:
        assert torch.isfinite(tgp[k]).all(), k
        _grad_close(tgp[k], jgp[k])
    _grad_close(tgx, jgx)


def test_mlstm_sequential_matches_jax():
    jp, tp = _params(JX.init_mlstm)
    x = _x(12, seed=1)
    jh, jst = JX.mlstm_sequential(jp, jnp.asarray(x), JC)
    th, tst = TX.mlstm_sequential(tp, torch.from_numpy(x), TC)
    _close(th, jh, M_ATOL, M_RTOL)
    _states_close(tst, jst, M_ATOL, M_RTOL)


def test_slstm_scan_matches_jax():
    """Values, end state and grads (w, r, b, wo and x) of the sequential
    sLSTM, within the reference's 1e-5 / 1e-4."""
    jp, tp = _params(JX.init_slstm)
    x = _x(12, seed=2)
    jh, jst = JX.slstm_scan(jp, jnp.asarray(x), JC)
    th, tst = TX.slstm_scan(tp, torch.from_numpy(x), TC)
    _close(th, jh, S_ATOL, S_RTOL)
    _states_close(tst, jst, S_ATOL, S_RTOL)
    (jgp, jgx), (tgp, tgx) = _grads(JX.apply_slstm_block, TX.apply_slstm_block,
                                    jp, tp, x, 2)
    assert tgp.keys() == jgp.keys()
    for k in jgp:
        _close(tgp[k], jgp[k], S_ATOL, S_RTOL)
    _close(tgx, jgx, S_ATOL, S_RTOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_steps_match_jax(kind):
    """Five decode steps from the initial state: each step's output and the
    state after it (written in place in the port) against the JAX step."""
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    jp, tp = _params(init, seed=3)
    jstep = getattr(JX, f"apply_{kind}_block_step")
    tstep = getattr(TX, f"apply_{kind}_block_step")
    jst = getattr(JX, f"init_{kind}_state")(JC, 2)
    tst = getattr(TX, f"init_{kind}_state")(TC, 2, "cpu")
    atol, rtol = (M_ATOL, M_RTOL) if kind == "mlstm" else (S_ATOL, S_RTOL)
    x = _x(5, seed=4)
    for t in range(5):
        jo, jst = jstep(jp, jnp.asarray(x[:, t:t + 1]), JC, jst)
        to, tst2 = tstep(tp, torch.from_numpy(x[:, t:t + 1]), TC, tst)
        assert tst2 is tst
        _close(to, jo, atol, rtol)
        _states_close(tst, jst, atol, rtol)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_state_inits_match_jax(kind):
    """Zeros and -inf stabilisers of the JAX shapes and dtypes; each leaf a
    tensor of its own (a decode step writes them in place)."""
    jst = getattr(JX, f"init_{kind}_state")(JC, 3)
    tst = getattr(TX, f"init_{kind}_state")(TC, 3, "cpu")
    assert tst.keys() == jst.keys()
    for k in jst:
        assert tst[k].dtype == torch.float32
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    ptrs = [t.data_ptr() for t in tst.values()]
    assert len(set(ptrs)) == len(ptrs)


@pytest.mark.parametrize("s", [16, 33])
def test_port_chunkwise_equals_sequential(s):
    """The port's chunkwise mLSTM against its own sequential oracle (the
    twin of tests/test_models.py:115-118)."""
    _, tp = _params(JX.init_mlstm, seed=5)
    x = torch.from_numpy(_x(s, seed=6))
    h1, s1 = TX.mlstm_sequential(tp, x, TC)
    h2, s2 = TX.mlstm_chunkwise(tp, x, TC)
    _close(h2, h1.numpy(), M_ATOL, M_RTOL)
    _states_close(s2, {k: v.numpy() for k, v in s1.items()}, M_ATOL, M_RTOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_port_steps_equal_scan(kind):
    """Decoding a sequence step by step gives the full-sequence block's
    outputs and end state (the twin of tests/test_models.py:121-131)."""
    init = JX.init_mlstm if kind == "mlstm" else JX.init_slstm
    _, tp = _params(init, seed=7)
    x = torch.from_numpy(_x(20, seed=8))
    if kind == "mlstm":
        h, end = TX.mlstm_chunkwise(tp, x, TC)
        atol, rtol = M_ATOL, M_RTOL
    else:
        h, end = TX.slstm_scan(tp, x, TC)
        atol, rtol = S_ATOL, S_RTOL
    full = TX._merge_heads(h, tp["wo"])
    st = getattr(TX, f"init_{kind}_state")(TC, 2, "cpu")
    step = getattr(TX, f"apply_{kind}_block_step")
    outs = [step(tp, x[:, t:t + 1], TC, st)[0] for t in range(20)]
    _close(torch.cat(outs, 1), full.numpy(), atol, rtol)
    _states_close(st, {k: v.numpy() for k, v in end.items()}, atol, rtol)
