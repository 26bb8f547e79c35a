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
