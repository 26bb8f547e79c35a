"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances are the JAX kernel tests' own: 3e-5 in fp32, 2.5e-2 in bf16.
Both sides compute in fp32 from the same inputs, so in bf16 each O element
is also held to 1e-4 + 1e-2 |O| (one bf16 rounding is at most 2**-7 |O|)
and the fp32 LSE to 1e-4, as ``chip_smoke.py`` does.
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
