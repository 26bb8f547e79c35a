"""repro_torch flash-attention forward vs the JAX package's Pallas kernel.

On the CPU the port's wrapper computes its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as its own kernel tests do.
Inputs come from a numpy seed, cast to the test dtype on each side.
Tolerances are the JAX kernel tests' own: 3e-5 in fp32, 2.5e-2 in bf16.
The kernel itself is checked against the plain version on the card by
``tests/test_torch_gpu.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# b, s, nq, nkv, hd, dtype, window, softcap (tests/test_kernels.py SWEEP)
SWEEP = [
    (2, 64, 4, 2, 32, "float32", 0, 0.0),
    (2, 64, 4, 1, 32, "float32", 16, 0.0),
    (1, 96, 8, 8, 16, "float32", 0, 20.0),
    (2, 64, 4, 2, 32, "bfloat16", 0, 0.0),
    (1, 40, 2, 2, 64, "float32", 0, 0.0),
    (1, 128, 16, 4, 8, "float32", 32, 50.0),
    (3, 32, 2, 2, 128, "bfloat16", 8, 0.0),
]


def _tol(dtype):
    return 2.5e-2 if dtype == "bfloat16" else 3e-5


def _qkv(b, sq, sk, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, nq, hd), np.float32),
            rng.standard_normal((b, sk, nkv, hd), np.float32),
            rng.standard_normal((b, sk, nkv, hd), np.float32))


def _both(arrays, dtype):
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    """The CPU path is the plain version: the kernel counter never moves."""
    assert tfa.flash_attention_fwd.launches == 0
    yield
    assert tfa.flash_attention_fwd.launches == 0


@pytest.mark.parametrize("b,s,nq,nkv,hd,dtype,window,softcap", SWEEP)
def test_flash_fwd_matches_pallas(b, s, nq, nkv, hd, dtype, window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, nq, nkv, hd), dtype)
    want = jops.flash_attention(jq, jk, jv, True, window, softcap, None,
                                32, 32, True)
    want_o, want_lse = jfa.flash_attention_fwd(
        jq, jk, jv, causal=True, window=window, softcap=softcap,
        block_q=32, block_k=32, interpret=True, return_lse=True)
    got_o, got_lse = tfa.flash_attention_fwd(
        tq, tk, tv, causal=True, window=window, softcap=softcap,
        return_lse=True)
    assert got_o.dtype == tq.dtype and tuple(got_o.shape) == (b, s, nq, hd)
    assert got_lse.dtype == torch.float32
    assert tuple(got_lse.shape) == (b, s, nkv, nq // nkv)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got_o), _np(want), atol=tol)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=tol)
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=tol)
    # ops.flash_attention (the autograd wrapper) is the same function
    got_ops = tops.flash_attention(tq, tk, tv, True, window, softcap)
    np.testing.assert_array_equal(_np(got_ops), _np(got_o))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_fwd_q_offset(dtype):
    """Queries start at global position q_offset over a longer kv side."""
    b, sq, sk, nq, nkv, hd = 2, 24, 56, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, sq, sk, nq, nkv, hd, 1), dtype)
    kw = dict(causal=True, window=20, softcap=0.0, q_offset=sk - sq)
    want_o, want_lse = jfa.flash_attention_fwd(
        jq, jk, jv, block_q=16, block_k=16, interpret=True, return_lse=True,
        **kw)
    got_o, got_lse = tfa.flash_attention_fwd(tq, tk, tv, return_lse=True, **kw)
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=tol)
    np.testing.assert_allclose(_np(got_lse), _np(want_lse), atol=tol)


@pytest.mark.parametrize("b,s,nq,nkv,hd,dtype,window,softcap", SWEEP[:3])
def test_ref_matches_jax_ref(b, s, nq, nkv, hd, dtype, window, softcap):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, s, nq, nkv, hd, 2), dtype)
    want = jref.flash_attention_ref(jq, jk, jv, window=window, softcap=softcap)
    got = tref.flash_attention_ref(tq, tk, tv, window=window, softcap=softcap)
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))


def test_backward_first_order_matches_plain():
    """The backward (the dq and dk/dv kernels; their plain version on the
    CPU) gives autograd's grads through the plain forward."""
    _, (tq, tk, tv) = _both(_qkv(1, 8, 8, 2, 2, 8), "float32")
    tq.requires_grad_(True)
    (dq,) = torch.autograd.grad(tops.flash_attention(tq, tk, tv).square().sum(), tq)
    (want,) = torch.autograd.grad(
        tref.flash_attention_ref(tq, tk, tv).square().sum(), tq)
    np.testing.assert_allclose(_np(dq), _np(want), atol=2e-4, rtol=1e-3)


def test_backward_raises_not_ported():
    """A second-order backward through flash attention is not ported (nor is
    it in the JAX twin's custom_vjp) and raises."""
    _, (tq, tk, tv) = _both(_qkv(1, 8, 8, 2, 2, 8), "float32")
    tq.requires_grad_(True)
    out = tops.flash_attention(tq, tk, tv)
    (dq,) = torch.autograd.grad(out.square().sum(), tq, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


@pytest.mark.parametrize("shape,match", [
    ((1, 8, 2, 264), "head_dim"),   # past the kernels' 256
    ((1, 8, 2, 12), "head_dim"),
])
def test_kernel_rejects_what_it_does_not_take(shape, match):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        tfa._check(q, q, q)
    with pytest.raises(TypeError):
        tfa._check(q.half(), q.half(), q.half())
