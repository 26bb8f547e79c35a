"""Flash-attention forward: the CUDA kernel's wrapper.

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` for a
CUDA tensor and computes its plain version (``ref.flash_attention_ref``)
for a CPU tensor; any
other device raises. The kernel replaces the JAX package's Pallas
``_kernel`` (``repro/kernels/flash_attention.py``) and keeps its layout:
q (b, sq, nq, hd), k/v (b, sk, nkv, hd); O in the input dtype and LSE
(b, sq, nkv, m) in fp32, m = nq // nkv.

``flash_attention_fwd.launches`` counts kernel launches (and nothing else),
so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


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


def _lib():
    lib = build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                       ll, ll, ll, ll, ll, ll, ll, ll, ll,
                       i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


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
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    out = torch.empty((b, sq, nq, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, sq, nkv, nq // nkv), dtype=torch.float32,
                      device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), _DTYPES[q.dtype], b, sq, sk, nq, nkv, hd,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(bool(causal)), int(window or 0), int(q_offset),
                 float(softcap or 0.0), float(scale),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_fwd.launches += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
