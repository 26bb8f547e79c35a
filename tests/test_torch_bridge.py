"""repro_torch.bridge: JAX param trees <-> port tensors, bit-exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import model as M
from repro_torch import bridge

ARCHS = ["llama-65b", "gpt3-96b", "qwen1.5-0.5b"]


def _jax_params(arch, dtype=None):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=3)
    params = M.init_params(jax.random.PRNGKey(0), cfg)
    if dtype is not None:
        params = jax.tree.map(lambda a: a.astype(dtype), params)
    return cfg, jax.tree.map(np.asarray, params)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_round_trip_bit_exact(arch):
    _, params = _jax_params(arch)
    tp = bridge.to_torch(params, device="cpu")
    back = bridge.to_numpy(tp)
    a, b = dict(_leaves(params)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
        assert np.array_equal(a[k].view(np.uint32), b[k].view(np.uint32)), k


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_round_trip_bit_exact(arch):
    _, params = _jax_params(arch, jnp.bfloat16)
    tp = bridge.to_torch(params, device="cpu")
    for k, t in _leaves(tp):
        assert t.dtype == torch.bfloat16, k
    back = bridge.to_numpy(tp)
    a, b = dict(_leaves(params)), dict(_leaves(back))
    assert a.keys() == b.keys()
    for k in a:
        assert b[k].dtype == a[k].dtype, k
        assert np.array_equal(a[k].view(np.uint16), b[k].view(np.uint16)), k
    # the uint16 view carries the values, not just the bits
    emb = np.asarray(params["embed"]["table"], np.float32)
    np.testing.assert_array_equal(tp["embed"]["table"].float().numpy(), emb)


def test_keys_and_stacked_layout():
    """embed/{table,unembed}, blocks/pos{j} stacked over n_full, final_norm."""
    cfg, params = _jax_params("llama-65b")
    tp = bridge.to_torch(params, device="cpu")
    assert set(tp) == {"embed", "blocks", "final_norm"}
    assert set(tp["embed"]) == {"table", "unembed"}
    assert set(tp["blocks"]) == {"pos0"}
    wq = tp["blocks"]["pos0"]["mixer"]["wq"]
    assert tuple(wq.shape) == (3, cfg.d_model, cfg.num_heads, cfg.head_dim)
