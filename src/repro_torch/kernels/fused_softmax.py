"""Fused scale-mask-softmax: the wrappers of the CUDA forward and backward
kernels.

``fused_softmax_fwd`` launches ``csrc/fused_softmax_fwd.cu`` for a CUDA
tensor and computes its plain version (``ref.fused_softmax_ref``) for a CPU
tensor; any other device raises. The kernel replaces the JAX package's
Pallas ``_fwd_kernel`` (``repro/kernels/fused_softmax.py``): fp32 upcast,
scale, the causal mask ``(row % sk) >= col`` to NEG_INF, a max-subtracted
softmax, downcast. ``fused_softmax_bwd`` is the twin of ``_bwd_kernel``
(``csrc/fused_softmax_bwd.cu``; plain version ``ref.fused_softmax_bwd_ref``):
dx = y (dy - sum(y dy)) scale. Both take (..., sq, sk) scores and run the
kernel over the (rows, sk) view, rows = everything before the last axis;
the mask holds for square scores only, which ``ops.fused_softmax`` asserts.

``fused_softmax_fwd.launches`` and ``fused_softmax_bwd.launches`` count
kernel launches (and nothing else), so a run can show that it went through
the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_softmax_bwd_ref, fused_softmax_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib(name, n_ptrs):
    """The C entry point ``name`` of ``csrc/<name>.cu``: ``n_ptrs`` tensor
    pointers, dtype, rows, sk, (the forward's causal flag), scale, stream."""
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        causal = [i] if name == "fused_softmax_fwd" else []
        fn.argtypes = [p] * n_ptrs + [i, ll, i] + causal + [f, p]
        fn.restype = ctypes.c_int
    return fn


def _rows(t, name):
    """``t`` as a contiguous (rows, sk) CUDA tensor the kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name} takes fp32 or bf16, got {t.dtype}")
    if t.dim() < 1 or t.numel() == 0:
        raise ValueError(f"{name} needs a non-empty (..., sk) tensor, got "
                         f"{tuple(t.shape)}")
    return t.reshape(-1, t.shape[-1]).contiguous()


def _launch(fn, name, ptrs, dtype, rows, sk, extra, device):
    with torch.cuda.device(device):
        err = fn(*ptrs, _DTYPES[dtype], rows, sk, *extra,
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def fused_softmax_fwd(x, *, scale=1.0, causal=False):
    """x: (..., sq, sk) scores -> y of x's shape and dtype."""
    if causal and (x.dim() < 2 or x.shape[-2] != x.shape[-1]):
        raise ValueError(f"the causal mask needs square scores, got "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_softmax_ref(x, scale=scale, causal=causal)
    x2 = _rows(x, "fused_softmax_fwd")
    y = torch.empty_like(x2)
    _launch(_lib("fused_softmax_fwd", 2), "fused_softmax_fwd",
            (x2.data_ptr(), y.data_ptr()), x.dtype, *x2.shape,
            (int(bool(causal)), float(scale)), x.device)
    fused_softmax_fwd.launches += 1
    return y.view(x.shape)


fused_softmax_fwd.launches = 0


def fused_softmax_bwd(y, dy, *, scale=1.0):
    """dx of the forward that gave ``y``, for the incoming grad ``dy``; both
    (..., sq, sk) of one dtype."""
    if y.device.type == "cpu":
        return fused_softmax_bwd_ref(y, dy, scale=scale)
    if dy.shape != y.shape or dy.dtype != y.dtype or dy.device != y.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} {dy.device} must "
                         f"match y {tuple(y.shape)} {y.dtype} {y.device}")
    y2, dy2 = _rows(y, "fused_softmax_bwd"), _rows(dy, "fused_softmax_bwd")
    dx = torch.empty_like(y2)
    _launch(_lib("fused_softmax_bwd", 3), "fused_softmax_bwd",
            (y2.data_ptr(), dy2.data_ptr(), dx.data_ptr()), y.dtype, *y2.shape,
            (float(scale),), y.device)
    fused_softmax_bwd.launches += 1
    return dx.view(y.shape)


fused_softmax_bwd.launches = 0
