"""Flash attention: the wrappers of the CUDA forward and backward kernels.

``flash_attention_fwd`` computes its plain version
(``ref.flash_attention_ref``) for a CPU tensor and launches a kernel for a
CUDA tensor; any other device raises. The kernels replace the JAX
package's Pallas ``_kernel`` (``repro/kernels/flash_attention.py``) and
keep its layout: q (b, sq, nq, hd), k/v (b, sk, nkv, hd); O in the input
dtype and LSE (b, sq, nkv, m) in fp32, m = nq // nkv.

``flash_attention_bwd`` is the two-pass backward: a dq kernel (the twin of
``_dq_kernel``) and a dk/dv kernel (the twin of ``_dkv_kernel``) for CUDA
tensors, ``ref.flash_attention_bwd_ref`` for CPU tensors. D = rowsum(dO *
O) is computed in plain torch (``ref.flash_attention_delta``) before the
two launches, as the JAX package computes it outside its kernels;
``ref.flash_attention_dq_ref`` and ``ref.flash_attention_dkv_ref`` are the
plain versions of the two kernels.

Every kernel has two routes, chosen by dtype alone (``route``), with no
fallback between them:
  * bf16 -> "sm90": ``csrc/flash_attention_{fwd,dq,dkv}_sm90.cu``, wgmma on
    bf16 tiles fed by TMA. TMA takes a 16-byte aligned base and strides
    that are multiples of 16 bytes: anything else raises a ValueError
    before a launch.
  * fp32 -> "fma": ``csrc/flash_attention_{fwd,dq,dkv}.cu``, exact fp32
    products on the CUDA cores (wgmma would run fp32 as TF32).

Both routes take head_dim in multiples of 8 from 8 to 256 (the Pallas
kernel takes the whole head too): past 128 the sm90 kernels run the
output's head_dim in two passes of 128 columns, and the fp32 kernels take
tiles of 32 keys.

``flash_attention_fwd.launches``, ``flash_attention_bwd.dq_launches`` and
``flash_attention_bwd.dkv_launches`` count kernel launches of either route
(and nothing else), so a run can show that it went through the kernels.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (flash_attention_bwd_ref, flash_attention_delta,
                                     flash_attention_ref)

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
#: the C entry point of each kernel on each route
_ENTRIES = {("fwd", "sm90"): "flash_attention_fwd_sm90",
            ("fwd", "fma"): "flash_attention_fwd",
            ("dq", "sm90"): "flash_attention_dq_sm90",
            ("dq", "fma"): "flash_attention_dq",
            ("dkv", "sm90"): "flash_attention_dkv_sm90",
            ("dkv", "fma"): "flash_attention_dkv"}


def route(dtype):
    """The kernels a CUDA tensor of ``dtype`` goes to: "sm90" for bf16,
    "fma" for fp32."""
    if dtype == torch.bfloat16:
        return "sm90"
    if dtype == torch.float32:
        return "fma"
    raise TypeError(f"the flash kernels take fp32 or bf16, not {dtype}")


def _check_tma(**tensors):
    """Raise a ValueError unless TMA can read each (b, s, heads, hd) tensor:
    a 16-byte aligned base and strides that are multiples of 16 bytes."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the bf16 kernels load by TMA, which "
                             f"needs a 16-byte aligned base address")
        if any(st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"{name}: strides {tuple(t.stride())} are not all "
                             f"multiples of 16 bytes, as TMA needs")


def _entry(kernel, **tensors):
    """The C entry point of ``kernel`` ("fwd", "dq" or "dkv") on the route
    of q's dtype; on the bf16 route only once TMA can read every tensor
    given."""
    kind = route(tensors["q"].dtype)
    if kind == "sm90":
        _check_tma(**tensors)
    return _ENTRIES[kernel, kind]


def _check(q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd takes fp32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (b, s, heads, hd)")
    b, sq, nq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or nq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes multiples of 8 "
                         f"from 8 to {MAX_HEAD_DIM}")
    if nq // k.shape[2] > 64:
        raise ValueError(f"{nq // k.shape[2]} query heads per kv head; the "
                         f"kernel takes at most 64")
    if min(t.stride(-1) for t in (q, k, v)) != 1:
        raise ValueError("q/k/v need a unit stride on head_dim")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v lie on different devices")


def _lib(name, n_ptrs, n_ints, n_strides):
    """The C entry point ``name`` of ``csrc/<name>.cu``: ``n_ptrs`` tensor
    pointers, ``n_ints`` ints (the six sizes), ``n_strides`` strides, the
    masks, softcap, scale and the stream."""
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = ([p] * n_ptrs + [i] * n_ints + [ll] * n_strides
                       + [i, i, i, f, f, p])
        fn.restype = ctypes.c_int
    return fn


def _raise_if(err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, q_offset=0, return_lse=False):
    """q: (b, sq, nq, hd); k/v: (b, sk, nkv, hd). Returns O, or (O, LSE).

    ``q_offset`` shifts the queries' positions for the causal/window masks:
    query row i is at global position i + q_offset while keys cover
    [0, sk).
    """
    if q.device.type == "cpu":
        return flash_attention_ref(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    name = _entry("fwd", q=q, k=k, v=v)
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    out = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, nkv, nq // nkv), dtype=torch.float32,
                      device=q.device)
    fn = _lib(name, 5, 6, 9)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), b, sq, sk, nq, nkv, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(bool(causal)), int(window or 0), int(q_offset),
                 float(softcap or 0.0), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _raise_if(err, name)
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0, scale=None, q_offset=0):
    """dq, dk, dv of the forward that gave ``out`` and ``lse``.

    q/out/dout: (b, sq, nq, hd); k/v: (b, sk, nkv, hd); lse: (b, sq, nkv, m)
    fp32. dq comes back in q's dtype, dk/dv in k's and v's (one dtype for
    all on the card). ``q_offset`` as in the forward.
    """
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window,
            softcap=softcap, scale=scale, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not {q.device}")
    _check(q, k, v)
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.stride(-1) != 1:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} with a unit last stride")
    if (lse.shape != (b, sq, nkv, nq // nkv) or lse.dtype != torch.float32
            or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want a "
                         f"contiguous fp32 (b, sq, nkv, m)")
    if not (dout.device == out.device == lse.device == q.device):
        raise ValueError("q/out/lse/dout lie on different devices")
    dq_name = _entry("dq", q=q, k=k, v=v, dout=dout)
    dkv_name = _entry("dkv", q=q, k=k, v=v, dout=dout)
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    delta = flash_attention_delta(out, dout, lse)
    dq = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, nkv, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, sk, nkv, hd), dtype=v.dtype, device=q.device)
    common = (b, sq, sk, nq, nkv, hd,
              *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
              *dout.stride()[:3], int(bool(causal)), int(window or 0),
              int(q_offset), float(softcap or 0.0), float(scale))
    fn_dq = _lib(dq_name, 7, 6, 12)
    fn_dkv = _lib(dkv_name, 8, 6, 12)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn_dq(*ptrs, dq.data_ptr(), *common, stream)
        _raise_if(err, dq_name)
        flash_attention_bwd.dq_launches += 1
        err = fn_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(), *common, stream)
        _raise_if(err, dkv_name)
        flash_attention_bwd.dkv_launches += 1
    return dq, dk, dv


flash_attention_bwd.dq_launches = 0
flash_attention_bwd.dkv_launches = 0
