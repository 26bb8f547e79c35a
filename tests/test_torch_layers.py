"""repro_torch.models.layers vs repro.models.layers on the same inputs (fp32).

Inputs come from a numpy seed; weights from the JAX init through the
bridge. Tolerance atol 1e-6 with rtol 1e-6 (about 8 fp32 ulps, for outputs
above 1): fp32 math on both sides, differing only in the order of the sums
and the last bit of tanh/cos/sin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import layers as TL

ATOL = 1e-6
RTOL = 1e-6
RNG = np.random.default_rng(0)


def _cfgs(arch, **kw):
    j = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)
    t = dataclasses.replace(tget_config(arch).reduced(), dtype="float32", **kw)
    return j, t


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=ATOL,
                               rtol=RTOL)


def _x(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm(norm):
    jc, tc = _cfgs("llama-65b", norm=norm)
    d = jc.d_model
    p = {"scale": 1.0 + 0.1 * _x(d)}
    if norm == "layernorm":
        p["bias"] = 0.1 * _x(d)
    x = _x(2, 5, d, scale=3.0) + 0.5
    want = JL.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = TL.apply_norm(bridge.to_torch(p, device="cpu"), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _x(2, 12, 4, 32)
    pos = RNG.integers(0, 4096, size=(2, 12)).astype(np.int32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got, want)


# ---------------------------------------------------------------------------
# rope_qk: q and k rotated together (one kernel launch a direction on a card)
# ---------------------------------------------------------------------------
# rope_qk's inputs come from a generator of their own, so that the tests
# after them draw what they drew before.
ROPE_RNG = np.random.default_rng(1)


def _rope_x(*shape):
    return torch.from_numpy(ROPE_RNG.standard_normal(shape).astype(np.float32))


def _qk(s, hd, dtype, nq=4, nkv=2, b=2):
    q = _rope_x(b, s, nq, hd).to(dtype)
    k = _rope_x(b, s, nkv, hd).to(dtype)
    pos = torch.from_numpy(ROPE_RNG.integers(0, 4096, size=(b, s)).astype(np.int32))
    return q, k, pos


def _rope_grads(f, q0, k0, pos, theta, gq, gk):
    q, k = q0.clone().requires_grad_(True), k0.clone().requires_grad_(True)
    yq, yk = f(q, k)
    return (yq, yk, *torch.autograd.grad((yq, yk), (q, k), (gq, gk)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,s", [(64, 12), (128, 5), (256, 3), (64, 1)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_qk_is_two_ropes_bit_for_bit(theta, hd, s, dtype):
    """On the CPU, rope_qk's outputs and the grads of q and k equal two
    calls of ``rope`` (the plain chain) through autograd, bit for bit."""
    q, k, pos = _qk(s, hd, dtype)
    gq, gk = (_rope_x(*t.shape).to(dtype) for t in (q, k))
    got = _rope_grads(lambda a, b: TL.rope_qk(a, b, pos, theta), q, k, pos,
                      theta, gq, gk)
    want = _rope_grads(lambda a, b: (TL.rope(a, pos, theta), TL.rope(b, pos, theta)),
                       q, k, pos, theta, gq, gk)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("hd,s", [(64, 4), (128, 2), (256, 1)])
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_qk_gradcheck(theta, hd, s):
    """The backward of both paths in float64: the plain chain through
    autograd (``layers.rope_qk`` on the CPU) and the kernel's autograd
    Function with its own backward, the rotation by the negated angles
    (``ops.rope_qk``, which takes the plain versions on the CPU)."""
    from repro_torch.kernels import ops
    q, k, pos = _qk(s, hd, torch.float64, nq=2, nkv=1, b=1)
    q.requires_grad_(True)
    k.requires_grad_(True)
    for f in (TL.rope_qk, ops.rope_qk):
        assert torch.autograd.gradcheck(lambda a, b: f(a, b, pos, theta), (q, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rope_kernel_backward_plain_version_is_autograds(dtype):
    """``ref.rope_bwd_ref`` (the rope kernel's backward, one rounding)
    equals autograd through the plain chain wherever autograd rounds once
    too: in fp32 and float64, bit for bit."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rope import freqs
    x = _rope_x(2, 7, 3, 64).to(dtype).requires_grad_(True)
    pos = torch.from_numpy(ROPE_RNG.integers(0, 4096, size=(2, 7)))
    g = _rope_x(2, 7, 3, 64).to(dtype)
    f = freqs(10_000.0, 32, "cpu")
    (want,) = torch.autograd.grad(ref.rope_ref(x, pos, f), x, g)
    assert torch.equal(ref.rope_bwd_ref(g, pos, f), want)


def test_rope_frequencies_are_made_once(monkeypatch):
    """The frequency table is built once per (theta, half, device): rope_qk
    converts no numpy array after its first call, forward or backward, and
    launches no kernel on the CPU."""
    from repro_torch.kernels import rope as R
    theta = 123_457.0
    for key in [k for k in R._FREQS if k[0] == theta]:
        del R._FREQS[key]
    q, k, pos = _qk(6, 64, torch.float32)
    q.requires_grad_(True)
    made = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: made.append(a) or real(a))
    launches = (R.rope_fwd.launches, R.rope_bwd.launches)
    for _ in range(3):
        yq, yk = TL.rope_qk(q, k, pos, theta)
        (yq.sum() + yk.sum()).backward()
        TL.rope(k, pos, theta)
    assert len(made) == 1
    table = R.freqs(theta, 32, "cpu")
    assert table is R.freqs(theta, 32, torch.device("cpu"))
    want = theta ** (-np.arange(0, 32, dtype=np.float32) / 32)
    assert table.dtype == torch.float32 and np.array_equal(table.numpy(), want)
    R.freqs(theta, 64, "cpu")  # another half: another table
    assert len(made) == 2
    assert (R.rope_fwd.launches, R.rope_bwd.launches) == launches


# The MLP's outputs reach |y| of about 2.3 through a 512-long sum, where
# fp32's rounding floor is about 1e-6: JAX and the port each land about
# 1.0e-6 from a float64 evaluation, so 1e-6 between the two is a coin toss
# of summation order (it failed on one host, passed on another). Each side
# is held to float64 within MLP_ATOL, and the two to each other at the
# ROADMAP's fp32 bar (tests/test_executor.py: atol 2e-6, rtol 1e-4).
MLP_ATOL = 4e-6


@pytest.mark.parametrize("arch", ["llama-65b", "gpt3-96b"])
def test_mlp(arch):
    """SwiGLU (llama) and tanh-approximate GELU (gpt3)."""
    jc, tc = _cfgs(arch)
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(1), jc))
    x = _x(2, 6, jc.d_model)
    want = np.asarray(JL.apply_mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jc))
    got = TL.apply_mlp(bridge.to_torch(p, device="cpu"), torch.from_numpy(x),
                       tc).numpy()
    exact = TL.apply_mlp({k: torch.tensor(v, dtype=torch.float64) for k, v in p.items()},
                         torch.from_numpy(x).double(), tc).numpy()
    np.testing.assert_allclose(want, exact, atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(got, exact, atol=MLP_ATOL, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-4)


@pytest.mark.parametrize("arch,kw", [
    ("llama-65b", {}),                      # untied
    ("qwen1.5-0.5b", {}),                   # tied, sqrt(d)-scaled
    ("gemma2-9b", {}),                      # tied + final softcap
    ("llama-65b", {"final_softcap": 5.0}),  # untied + softcap
])
def test_embed_unembed(arch, kw):
    jc, tc = _cfgs(arch, **kw)
    p = jax.tree.map(np.asarray, JL.init_embed(jax.random.PRNGKey(2), jc))
    tok = RNG.integers(0, jc.vocab_size, size=(2, 7)).astype(np.int32)
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")
    want_x = JL.embed(jp, jnp.asarray(tok), jc)
    got_x = TL.embed(tp, torch.from_numpy(tok).long(), tc)
    _close(got_x, want_x)
    h = _x(2, 7, jc.d_model)
    want = JL.unembed(jp, jnp.asarray(h), jc)
    got = TL.unembed(tp, torch.from_numpy(h), tc)
    assert got.dtype == torch.float32
    _close(got, want)


def test_softcap_and_cdtype():
    x = _x(64, scale=50.0)
    _close(TL.softcap(torch.from_numpy(x), 30.0), JL.softcap(jnp.asarray(x), 30.0))
    t = torch.from_numpy(x)
    assert TL.softcap(t, 0.0) is t  # cap 0 is off, as in the JAX twin
    _, tc = _cfgs("llama-65b")
    assert TL.cdtype(tc) == torch.float32
    assert TL.cdtype(tget_config("llama-65b")) == torch.bfloat16


# ---------------------------------------------------------------------------
# cast_matmul: the product that saves the fp32 weight, not its cast copy
# ---------------------------------------------------------------------------
def _weight(kind):
    """A fp32 leaf and the 2-D weight the layers hand cast_matmul: a matrix,
    a (d, n, h) projection flattened to (d, n*h), and a tied table taken
    transposed (column-major)."""
    if kind == "matrix":
        w = torch.from_numpy(_x(32, 48)).requires_grad_(True)
        return w, w
    if kind == "heads":
        w = torch.from_numpy(_x(32, 4, 12)).requires_grad_(True)
        return w, w.reshape(32, 48)
    w = torch.from_numpy(_x(48, 32)).requires_grad_(True)
    return w, w.T


@pytest.mark.parametrize("kind", ["matrix", "heads", "tied"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cast_matmul_is_bit_equal_to_cast_then_matmul(dtype, kind):
    """Forward, grad_x and grad_w equal ``x @ w.to(dtype)`` through
    autograd bit for bit."""
    leaf, w = _weight(kind)
    x0 = torch.from_numpy(_x(3, 5, 32)).to(dtype)
    g = torch.from_numpy(_x(3, 5, 48)).to(dtype)
    outs = []
    for f in (lambda x: TL.cast_matmul(x, w), lambda x: x @ w.to(dtype)):
        x = x0.clone().requires_grad_(True)
        y = f(x)
        outs.append((y, *torch.autograd.grad(y, (x, leaf), g, retain_graph=True)))
    (y, gx, gw), (wy, wgx, wgw) = outs
    assert y.dtype == dtype and gw.dtype == torch.float32
    for a, b in ((y, wy), (gx, wgx), (gw, wgw)):
        assert a.shape == b.shape and torch.equal(a, b)


def test_cast_matmul_saves_no_weight_copy():
    """A bf16 stage unit's box holds the activations the backward reads but
    no bf16 copy of any weight: the fp32 weights are the step's own (kept,
    not boxed). The box of the same forward through ``x @ w.to(bf16)``
    holds each weight's copy as well."""
    from repro_torch.memory.offload import Box
    cfg = dataclasses.replace(tget_config("llama-65b").reduced(),
                              dtype="bfloat16")
    p = TL.init_mlp(torch.Generator().manual_seed(0), cfg, "cpu")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    x = torch.from_numpy(_x(2, 8, cfg.d_model)).to(torch.bfloat16)
    x.requires_grad_(True)  # a stage's input activation, as in the executor
    copies = sum(w.numel() * 2 for w in p.values())

    def plain(params, x_):
        dt = x_.dtype
        h = torch.nn.functional.silu(x_ @ params["wi"].to(dt)) * (
            x_ @ params["wg"].to(dt))
        return h @ params["wo"].to(dt)

    boxes = []
    for f in (lambda q, x_: TL.apply_mlp(q, x_, cfg), plain):
        box = Box(keep=list(p.values()) + [x])
        with torch.enable_grad(), box.hooks():
            y = f(p, x)
        boxes.append((box, y))
    (box, y), (plain_box, plain_y) = boxes
    assert torch.equal(y, plain_y)
    assert plain_box.nbytes() - box.nbytes() == copies
