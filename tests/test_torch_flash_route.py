"""The flash wrapper's routing and TMA checks, in pure Python on the CPU.

A CUDA tensor goes to one set of kernels (forward, dq, dk/dv) by its dtype
alone, with no fallback: bf16 to the sm90 kernels (wgmma and TMA), fp32 to
the fp32 FMA kernels.
The bf16 route raises a ValueError, before any allocation or launch, on
what TMA cannot read. ``_entry`` is that decision; it only reads dtypes,
base addresses and strides, so CPU tensors stand in for CUDA ones here.
CPU tensors themselves never reach it: the wrapper gives them the plain
version. The kernels are held to their plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref


def _qkv(dtype, hd=64):
    q = torch.zeros((1, 8, 4, hd), dtype=dtype)
    k = torch.zeros((1, 8, 2, hd), dtype=dtype)
    return q, k, k.clone()


def test_route_by_dtype():
    assert fa.route(torch.bfloat16) == "sm90"
    assert fa.route(torch.float32) == "fma"
    with pytest.raises(TypeError):
        fa.route(torch.float16)


@pytest.mark.parametrize("kernel,dtype,want", [
    ("fwd", torch.bfloat16, "flash_attention_fwd_sm90"),
    ("dq", torch.bfloat16, "flash_attention_dq_sm90"),
    ("fwd", torch.float32, "flash_attention_fwd"),
    ("dq", torch.float32, "flash_attention_dq"),
    ("dkv", torch.bfloat16, "flash_attention_dkv_sm90"),
    ("dkv", torch.float32, "flash_attention_dkv"),
])
def test_entry_by_dtype(kernel, dtype, want):
    q, k, v = _qkv(dtype)
    assert fa._entry(kernel, q=q, k=k, v=v, dout=torch.zeros_like(q)) == want


def _misaligned_stride(dtype):
    """q as a view whose head and position strides are 68 elements apart
    per head: 136 bytes in bf16, not a multiple of 16."""
    return torch.zeros((1, 8, 4, 68), dtype=dtype)[..., :64]


def _misaligned_base(dtype):
    """q whose first element sits 2 bf16 elements (4 bytes) past an aligned
    allocation, with strides that are multiples of 16 bytes."""
    flat = torch.zeros(2 + 8 * 4 * 64, dtype=dtype)
    return flat[2:].view(1, 8, 4, 64)


@pytest.mark.parametrize("make,match", [(_misaligned_stride, "strides"),
                                        (_misaligned_base, "aligned")])
@pytest.mark.parametrize("which", ["q", "k", "v", "dout"])
def test_bf16_route_raises_on_what_tma_cannot_read(make, match, which):
    q, k, v = _qkv(torch.bfloat16)
    tensors = dict(q=q, k=k, v=v, dout=torch.zeros_like(q))
    bad = make(torch.bfloat16)
    tensors[which] = bad if which in ("q", "dout") else bad[:, :, :2]
    for kernel in ("dq", "dkv"):
        with pytest.raises(ValueError, match=match):
            fa._entry(kernel, **tensors)
    if which != "dout":
        with pytest.raises(ValueError, match=match):
            fa._entry("fwd", **{n: tensors[n] for n in ("q", "k", "v")})


@pytest.mark.parametrize("make", [_misaligned_stride, _misaligned_base])
def test_fp32_route_takes_any_stride(make):
    q, k, v = _qkv(torch.float32)
    assert fa._entry("fwd", q=make(torch.float32), k=k, v=v) == "flash_attention_fwd"
    assert fa._entry("dkv", q=q, k=k, v=v, dout=make(torch.float32)) \
        == "flash_attention_dkv"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 128, 136, 192, 200, 256])
def test_head_dims_up_to_256_pass_the_wrapper(hd, dtype):
    """Multiples of 8 from 8 to 256 reach a kernel on either route (the
    instances past 128 split the output's head_dim into two passes)."""
    q, k, v = _qkv(dtype, hd)
    fa._check(q, k, v)
    assert fa._entry("fwd", q=q, k=k, v=v).startswith("flash_attention_fwd")


@pytest.mark.parametrize("hd", [264, 100, 4])
def test_other_head_dims_raise(hd):
    q, k, v = _qkv(torch.bfloat16, hd)
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(q, k, v)


def test_cpu_tensors_take_the_plain_version():
    """A bf16 CPU tensor TMA could not read still runs: the CPU path is the
    plain version, and no kernel launches."""
    before = fa.flash_attention_fwd.launches
    q = _misaligned_stride(torch.bfloat16)
    k = torch.randn((1, 8, 4, 64)).to(torch.bfloat16)
    out = fa.flash_attention_fwd(q, k, k, causal=True)
    assert torch.equal(out, ref.flash_attention_ref(q, k, k, causal=True))
    assert fa.flash_attention_fwd.launches == before
