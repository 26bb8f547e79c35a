"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the JAX kernel tests' own: 3e-5 in fp32, 2.5e-2 in bf16
for the forward, 2e-4 / 1e-3 for the backward's dq, dk and dv in fp32.
Both sides compute in fp32 from the same inputs, so in bf16 each O element
is also held to 1e-4 + 1e-2 |O| (one bf16 rounding is at most 2**-7 |O|)
and the fp32 LSE to 1e-4, as ``chip_smoke.py`` does; a bf16 gradient
element to 1e-2 |want| + 1e-3 max |want| beside the 2.5e-2 bound (the
sums run over many more terms than the forward's).
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

# b, sq, sk, nq, nkv, hd, dtype, window, softcap, q_offset
CASES = [
    (2, 64, 64, 4, 2, 32, "float32", 0, 0.0, 0),
    (2, 64, 64, 4, 1, 32, "float32", 16, 0.0, 0),
    (1, 96, 96, 8, 8, 16, "float32", 0, 20.0, 0),
    (2, 64, 64, 4, 2, 32, "bfloat16", 0, 0.0, 0),
    (1, 40, 40, 2, 2, 64, "float32", 0, 0.0, 0),
    (1, 128, 128, 16, 4, 8, "float32", 32, 50.0, 0),
    (3, 32, 32, 2, 2, 128, "bfloat16", 8, 0.0, 0),
    (2, 24, 56, 4, 2, 32, "float32", 20, 0.0, 32),
    (1, 300, 300, 6, 2, 96, "bfloat16", 0, 0.0, 0),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset", CASES)
def test_flash_kernel_matches_plain(cuda, b, sq, sk, nq, nkv, hd, dtype, window,
                                    softcap, q_offset):
    gen = torch.Generator(cuda).manual_seed(0)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset,
              return_lse=True)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
    tol = 2.5e-2 if dtype == "bfloat16" else 3e-5
    torch.testing.assert_close(out.float(), want_out.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=tol, rtol=0)
    if dtype == "bfloat16":
        torch.testing.assert_close(out.float(), want_out.float(), atol=1e-4,
                                   rtol=1e-2)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_strided_inputs(cuda):
    """q/k/v as views of one fused projection (non-contiguous heads)."""
    gen = torch.Generator(cuda).manual_seed(1)
    qkv = torch.randn((2, 70, 3, 4, 64), generator=gen, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = fa.flash_attention_fwd(q, k, v, causal=True)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, want, atol=3e-5, rtol=0)


@pytest.mark.gpu
def test_flash_kernel_rejects_wide_heads(cuda):
    q = torch.zeros((1, 8, 2, 136), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, q, q)


def _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, dtype, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, sk, nkv, hd), generator=gen, device=cuda).to(dt)
    do = torch.randn((b, sq, nq, hd), generator=gen, device=cuda).to(dt)
    return q, k, v, do


def _assert_grad_close(got, want, dtype):
    g, w = got.float(), want.float()
    if dtype == "bfloat16":
        torch.testing.assert_close(g, w, atol=2.5e-2, rtol=0)
        bound = 1e-2 * w.abs() + 1e-3 * w.abs().max()
        assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())
    else:
        torch.testing.assert_close(g, w, atol=2e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,nq,nkv,hd,dtype,window,softcap,q_offset", CASES)
def test_flash_bwd_kernels_match_plain(cuda, b, sq, sk, nq, nkv, hd, dtype,
                                       window, softcap, q_offset):
    q, k, v, do = _bwd_inputs(cuda, b, sq, sk, nq, nkv, hd, dtype)
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = (fa.flash_attention_bwd.dq_launches,
              fa.flash_attention_bwd.dkv_launches)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd.dq_launches,
            fa.flash_attention_bwd.dkv_launches) == (before[0] + 1,
                                                     before[1] + 1)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
    for t, w, src in zip(got, want, (q, k, v)):
        assert t.dtype == src.dtype and t.shape == src.shape
        _assert_grad_close(t, w, dtype)


@pytest.mark.gpu
def test_flash_bwd_kernels_are_deterministic(cuda):
    """One block owns each output tile and no atomics are used: two runs
    give the same bits."""
    q, k, v, do = _bwd_inputs(cuda, 2, 300, 300, 8, 2, 64, "bfloat16", 3)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, out, lse, do)
    second = fa.flash_attention_bwd(q, k, v, out, lse, do)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.gpu
def test_flash_bwd_strided_inputs_through_autograd(cuda):
    """q/k/v as views of one fused projection, and the strided dO an
    einsum's backward hands over, through ops.flash_attention."""
    from repro_torch.kernels import ops
    gen = torch.Generator(cuda).manual_seed(2)
    qkv = torch.randn((2, 70, 3, 4, 64), generator=gen, device=cuda,
                      requires_grad=True)
    wo = torch.randn((4, 64, 16), generator=gen, device=cuda)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = torch.autograd.grad(torch.einsum(
        "bsnh,nhd->bsd", ops.flash_attention(q, k, v), wo).square().sum(), qkv)
    want = torch.autograd.grad(torch.einsum(
        "bsnh,nhd->bsd", ref.flash_attention_ref(q, k, v), wo).square().sum(),
        qkv)
    torch.testing.assert_close(got[0], want[0], atol=2e-4, rtol=1e-3)


@pytest.mark.gpu
def test_flash_bwd_rejects_wide_heads(cuda):
    q = torch.zeros((1, 8, 2, 136), device=cuda)
    lse = torch.zeros((1, 8, 2, 1), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(q, q, q, q, lse, q)
