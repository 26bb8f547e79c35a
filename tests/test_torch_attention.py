"""repro_torch.models.attention vs repro.models.attention (fp32, CPU).

Weights come from the JAX init through the bridge, inputs from a numpy
seed. Tolerance 2e-4, the JAX package's own decode-vs-forward bound
(tests/test_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import attention as JA
from repro_torch import bridge
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as TA

TOL = 2e-4

CASES = [
    ("llama-65b", {}),
    ("llama-65b", {"num_kv_heads": 2}),   # GQA, m = 2
    ("gpt3-96b", {}),                     # qkv bias, LayerNorm family
    ("qwen3-14b", {}),                    # qk-norm, rope theta 1e6
    ("gemma2-9b", {}),                    # attention softcap
    ("qwen1.5-0.5b-swa", {"window_size": 8}),
]


def _cfgs(arch, **kw):
    j = dataclasses.replace(get_config(arch).reduced(**kw), dtype="float32")
    t = dataclasses.replace(tget_config(arch).reduced(**kw), dtype="float32")
    return j, t


def _params(jc):
    p = jax.tree.map(np.asarray, JA.init_attention(jax.random.PRNGKey(3), jc))
    # non-zero biases, so the bias path is exercised
    p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return jax.tree.map(jnp.asarray, p), bridge.to_torch(p, device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)


def _kind(cfg):
    return cfg.block_pattern[0]


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("arch,kw", CASES)
def test_attention_prefill(arch, kw, impl):
    jc, tc = _cfgs(arch, **kw)
    jp, tp = _params(jc)
    b, s = 2, 20
    x = np.random.default_rng(0).standard_normal((b, s, jc.d_model), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, (wk, wv) = JA.attention(jp, jnp.asarray(x), jc, jnp.asarray(pos),
                                  kind=_kind(jc), impl=impl)
    got, (gk, gv) = TA.attention(tp, torch.from_numpy(x),
                                 dataclasses.replace(tc, attn_impl=impl),
                                 torch.from_numpy(pos.copy()), kind=_kind(tc))
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)


@pytest.mark.parametrize("arch,kw", CASES)
def test_attention_decode_over_cache(arch, kw):
    """fill_kv_cache from a prefill, then decode steps through the cache
    (for the window case: around the ring)."""
    jc, tc = _cfgs(arch, **kw)
    jp, tp = _params(jc)
    kind = _kind(jc)
    b, sp, steps = 2, 12, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, sp, jc.d_model), np.float32)
    pos = np.broadcast_to(np.arange(sp, dtype=np.int32), (b, sp))
    _, (jk, jv) = JA.attention(jp, jnp.asarray(x), jc, jnp.asarray(pos), kind=kind)
    _, (tk, tv) = TA.attention(tp, torch.from_numpy(x), tc,
                               torch.from_numpy(pos.copy()), kind=kind)
    jcache = JA.fill_kv_cache(
        JA.init_kv_cache(jc, kind, b, sp + steps, jnp.float32), jk, jv)
    tcache = TA.fill_kv_cache(
        TA.init_kv_cache(tc, kind, b, sp + steps, torch.float32, "cpu"), tk, tv)
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    for i in range(steps):
        xt = rng.standard_normal((b, 1, jc.d_model), np.float32)
        want, jcache = JA.attention_decode(jp, jnp.asarray(xt), jc, jcache,
                                           jnp.int32(sp + i), kind=kind)
        got, tcache = TA.attention_decode(tp, torch.from_numpy(xt), tc, tcache,
                                          sp + i, kind=kind)
        _close(got, want)
        _close(tcache["k"], jcache["k"])
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


@pytest.mark.parametrize("s,n,start", [(5, 8, 0), (8, 8, 0), (13, 8, 0),
                                       (13, 8, 3), (21, 5, 2)])
def test_fill_kv_cache_ring(s, n, start):
    """Both branches of fill_kv_cache, the ring roll included."""
    jc, tc = _cfgs("qwen1.5-0.5b-swa", window_size=n)
    b = 2
    rng = np.random.default_rng(2)
    k = rng.standard_normal((b, s, jc.num_kv_heads, jc.head_dim), np.float32)
    v = rng.standard_normal(k.shape, np.float32)
    jcache = JA.fill_kv_cache(JA.init_kv_cache(jc, "local_attn", b, 64,
                                               jnp.float32),
                              jnp.asarray(k), jnp.asarray(v), start)
    tcache = TA.fill_kv_cache(TA.init_kv_cache(tc, "local_attn", b, 64,
                                               torch.float32, "cpu"),
                              torch.from_numpy(k), torch.from_numpy(v), start)
    for key in ("k", "v", "pos"):
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))


def test_sdpa_empty_slots_and_gqa():
    """_sdpa masks pos=-1 slots and groups heads as (nkv, m)."""
    jc, tc = _cfgs("llama-65b", num_kv_heads=1)
    b, sq, sk = 2, 3, 7
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, sq, jc.num_heads, jc.head_dim), np.float32)
    k = rng.standard_normal((b, sk, 1, jc.head_dim), np.float32)
    v = rng.standard_normal((b, sk, 1, jc.head_dim), np.float32)
    qpos = np.full((b, sq), 5, np.int32)
    kpos = np.array([[0, 1, 2, 3, -1, -1, -1], [4, 5, 6, 0, 1, 2, 3]], np.int32)
    want = JA._sdpa(*map(jnp.asarray, (q, k, v)), jc, jnp.asarray(qpos),
                    jnp.asarray(kpos), causal=True, window=3)
    got = TA._sdpa(*map(torch.from_numpy, (q, k, v)), tc, torch.from_numpy(qpos),
                   torch.from_numpy(kpos), causal=True, window=3)
    _close(got, want)


@pytest.mark.parametrize("path", ["attention", "attention_sliced", "attention_decode"])
@pytest.mark.parametrize("arch,kw", [("llama-65b", {"num_kv_heads": 2}),
                                     ("qwen3-14b", {})])
def test_one_rope_qk_call_rotates_q_and_k(monkeypatch, arch, kw, path):
    """Every self-attention path projects q, k and v (qk-norm first) and
    rotates q and k in one ``rope_qk`` call at its positions: the sliced
    path at the slice's offset, decode at the one position."""
    jc, tc = _cfgs(arch, **kw)
    _, tp = _params(jc)
    calls = []
    real = TA.rope_qk

    def counted(q, k, positions, theta):
        calls.append((q.shape, k.shape, positions.clone(), theta))
        return real(q, k, positions, theta)

    monkeypatch.setattr(TA, "rope_qk", counted)
    b, s, off = 2, 6, 4
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((b, s, jc.d_model), np.float32))
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    hd, nq, nkv = tc.head_dim, tc.num_heads, tc.num_kv_heads
    kind = _kind(tc)
    if path == "attention":
        TA.attention(tp, x, tc, pos, kind=kind)
        want_pos = pos
    elif path == "attention_sliced":
        prefix = torch.zeros((b, off, nkv, hd))
        TA.attention_sliced(tp, x, tc, pos + off, (prefix, prefix), kind=kind)
        want_pos = pos + off
    else:
        cache = TA.init_kv_cache(tc, kind, b, 16, torch.float32, "cpu")
        x, s = x[:, :1], 1
        TA.attention_decode(tp, x, tc, cache, off, kind=kind)
        want_pos = torch.full((b, 1), off, dtype=torch.int32)
    assert len(calls) == 1
    q_shape, k_shape, got_pos, theta = calls[0]
    assert q_shape == (b, s, nq, hd) and k_shape == (b, s, nkv, hd)
    assert torch.equal(got_pos, want_pos) and theta == tc.rope_theta
