"""repro_torch flash-attention backward vs the JAX package's Pallas kernels.

On the CPU the port's ``ops.flash_attention`` backward computes its plain
version (``ref.flash_attention_bwd_ref``); the JAX side takes ``jax.grad``
through ``repro.kernels.ops.flash_attention`` with the Pallas forward and
dq / dk-dv kernels in interpret mode, as ``tests/test_kernels.py`` runs
them. Inputs and the output cotangent come from a numpy seed.

Tolerance in fp32: 2e-4 / 1e-3, the JAX backward test's own. In bf16 both
sides sum in fp32 and round to bf16, so an element may differ by one bf16
rounding (at most 2**-7 of its size): rtol 2**-7, atol 2e-4. The kernels
themselves are held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ATOL, RTOL = 2e-4, 1e-3
BF16_RTOL = 2.0 ** -7

# b, sq, sk, nq, nkv, hd, dtype, window, softcap, q_offset
CASES = [
    (1, 32, 32, 4, 2, 16, "float32", 0, 0.0, 0),    # tests/test_kernels.py:53-58
    (1, 64, 64, 4, 1, 32, "float32", 16, 0.0, 0),   # GQA + sliding window
    (1, 48, 48, 8, 8, 16, "float32", 0, 20.0, 0),   # softcap chain rule
    (1, 40, 40, 2, 2, 32, "float32", 0, 0.0, 0),    # non-divisible -> padding
    (2, 24, 56, 4, 2, 32, "float32", 20, 0.0, 32),  # q_offset over a longer kv
    (2, 32, 32, 8, 2, 16, "float32", 0, 0.0, 0),    # GQA, m = 4, batch 2
    (2, 32, 32, 4, 2, 32, "bfloat16", 0, 0.0, 0),   # bf16 forward
]


def _arrays(b, sq, sk, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nq, hd), np.float32),
            rng.standard_normal((b, sk, nkv, hd), np.float32),
            rng.standard_normal((b, sk, nkv, hd), np.float32),
            rng.standard_normal((b, sq, nq, hd), np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, dtype):
    rtol = BF16_RTOL if dtype == "bfloat16" else RTOL
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=rtol)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """The CPU path is the plain version: the kernel counters never move."""
    counts = lambda: (tfa.flash_attention_bwd.dq_launches,
                      tfa.flash_attention_bwd.dkv_launches)
    assert counts() == (0, 0)
    yield
    assert counts() == (0, 0)


@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset",
                         CASES)
def test_grads_match_pallas(b, sq, sk, nq, nkv, hd, dtype, window, softcap,
                            q_offset):
    q, k, v, g = _arrays(b, sq, sk, nq, nkv, hd)
    jdt = getattr(jnp, dtype)

    def loss(q_, k_, v_):
        out = jops.flash_attention(q_, k_, v_, True, window, softcap, None,
                                   16, 16, True, q_offset)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_(True)
                  for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, True, window, softcap, None,
                               q_offset)
    got = torch.autograd.grad((out.float() * torch.from_numpy(g)).sum(),
                              (tq, tk, tv))
    for t, w, src in zip(got, want, (tq, tk, tv)):
        assert t.dtype == src.dtype and t.shape == src.shape
        _assert_close(t, w, dtype)


@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset",
                         [c for c in CASES if c[6] == "float32"])
def test_bwd_ref_equals_autograd_through_fwd_ref(b, sq, sk, nq, nkv, hd, dtype,
                                                 window, softcap, q_offset):
    """The plain backward is the gradient of the plain forward."""
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(b, sq, sk, nq, nkv, hd, 1))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = tref.flash_attention_ref(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad((out * g).sum(), (q, k, v))
    got = tref.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(), g,
                                       **kw)
    for t, w in zip(got, want):
        _assert_close(t, w, dtype)


def test_bwd_wrapper_on_cpu_is_the_plain_version():
    q, k, v, g = (torch.from_numpy(a) for a in _arrays(1, 20, 20, 4, 2, 8, 2))
    out, lse = tfa.flash_attention_fwd(q, k, v, return_lse=True)
    got = tfa.flash_attention_bwd(q, k, v, out, lse, g)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, g)
    for t, w in zip(got, want):
        torch.testing.assert_close(t, w, atol=0, rtol=0)


def test_bwd_takes_a_non_contiguous_cotangent():
    """An einsum's backward may hand the flash op a strided dO."""
    q, k, v, _ = (torch.from_numpy(a) for a in _arrays(1, 16, 16, 4, 4, 8, 3))
    wo = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 8, 12), np.float32))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    got = torch.autograd.grad(
        torch.einsum("bsnh,nhd->bsd", tops.flash_attention(q, k, v), wo).sum(),
        (q, k, v))
    want = torch.autograd.grad(
        torch.einsum("bsnh,nhd->bsd", tref.flash_attention_ref(q, k, v),
                     wo).sum(), (q, k, v))
    for t, w in zip(got, want):
        _assert_close(t, w, "float32")


def test_bwd_on_another_device_raises():
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_bwd(q, q, q, q, torch.zeros((1, 8, 2, 1),
                                                        device="meta"), q)
