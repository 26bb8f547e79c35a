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
