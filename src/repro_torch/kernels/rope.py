"""Rotary position embedding of q and k together: the wrapper of the CUDA
kernel ``csrc/rope.cu``, forward and backward.

``rope_fwd(q, k, positions, freq)`` rotates q (b, s, nq, hd) and k (b, s,
nkv, hd) by the angles ``positions`` (b, s) x ``freq`` (half,) in one launch
for a CUDA tensor, and computes the plain version (``ref.rope_ref``, the
port's original chain) for a CPU tensor; any other device raises.
``rope_bwd`` is the backward, the rotation by the negated angles of the
incoming gradients (plain version ``ref.rope_bwd_ref``), in one launch too.
The kernel replaces no TPU kernel (the JAX package leaves rope to XLA); see
the source for its design.

The kernel takes fp32 or bf16 q and k of one dtype, an even head_dim up to
``MAX_HEAD_DIM``, and int32 or int64 positions broadcastable to (b, s). The
rows (b, s, heads) may lie at any strides; a head_dim of any stride but 1 is
made contiguous first. Its outputs are contiguous. Anything else raises
before a launch.

``freqs(theta, half, device)`` is the frequency table: the JAX twin's numpy
float32 values, made and moved to ``device`` once per (theta, half, device)
and kept there, so no call copies it again.

``rope_fwd.launches`` and ``rope_bwd.launches`` count kernel launches (and
nothing else), so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rope_bwd_ref, rope_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POSITIONS = {torch.int32: 0, torch.int64: 1}
MAX_HEAD_DIM = 256
_FREQS: Dict[Tuple[float, int, torch.device], torch.Tensor] = {}


def freqs(theta: float, half: int, device) -> torch.Tensor:
    """theta ** (-i / half), i < half, in numpy float32 as the JAX twin
    computes them, on ``device``; made once per (theta, half, device). Made
    outside any dispatch mode (a dry run's ``FakeTensorMode``), so the table
    kept is always a real tensor."""
    key = (float(theta), int(half), torch.device(device))
    f = _FREQS.get(key)
    if f is None:
        from torch.utils._python_dispatch import _disable_current_modes
        table = float(theta) ** (-np.arange(0, half, dtype=np.float32) / half)
        with _disable_current_modes():
            f = torch.from_numpy(np.asarray(table, np.float32)).to(key[2])
        _FREQS[key] = f
    return f


def _lib():
    fn = build.load("rope").rope_qk
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * 8 + [ll] * 8 + [i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, positions, freq, name):
    if any(type(t) is not torch.Tensor for t in (q, k, positions, freq)):
        raise TypeError(f"{name} takes plain tensors, not "
                        f"{type(q).__name__} or {type(k).__name__}")
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype:
        raise TypeError(f"{name} takes fp32 or bf16 q and k of one dtype, got "
                        f"{q.dtype}, {k.dtype}")
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}: want "
                         f"(b, s, heads, hd) of one b, s and hd")
    hd = q.shape[3]
    if hd % 2 or not 2 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd}: the kernel takes an even head_dim "
                         f"from 2 to {MAX_HEAD_DIM}")
    if positions.dtype not in _POSITIONS:
        raise TypeError(f"{name} takes int32 or int64 positions, got "
                        f"{positions.dtype}")
    if freq.dtype != torch.float32 or freq.shape != (hd // 2,) \
            or not freq.is_contiguous():
        raise ValueError(f"freq {tuple(freq.shape)} {freq.dtype}: want a "
                         f"contiguous fp32 ({hd // 2},)")
    if not (q.device == k.device == positions.device == freq.device):
        raise ValueError("q, k, positions and freq lie on different devices")


def _vec(half, *tensors):
    """16 / the element size where every base and row stride and ``half``
    allow 16-byte accesses, else 1."""
    vec = 16 // tensors[0].element_size()
    if half % vec:
        return 1
    for t in tensors:
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            return 1
    return vec


def _launch(q, k, positions, freq, inverse, name):
    _check(q, k, positions, freq, name)
    q = q if q.stride(3) == 1 else q.contiguous()
    k = k if k.stride(3) == 1 else k.contiguous()
    b, s, nq, hd = q.shape
    nkv = k.shape[2]
    pos = torch.broadcast_to(positions, (b, s))
    qo = torch.empty((b, s, nq, hd), dtype=q.dtype, device=q.device)
    ko = torch.empty((b, s, nkv, hd), dtype=k.dtype, device=k.device)
    if qo.numel() == 0 and ko.numel() == 0:
        return qo, ko, False
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                     pos.data_ptr(), freq.data_ptr(), _DTYPES[q.dtype],
                     _POSITIONS[pos.dtype], _vec(hd // 2, q, k), b, s, nq, nkv,
                     hd // 2, *q.stride()[:3], *k.stride()[:3], *pos.stride(),
                     int(inverse), torch._C._cuda_getCurrentRawStream(q.device.index))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return qo, ko, True


def rope_fwd(q, k, positions, freq):
    """(q, k) rotated by the angles positions x freq; q (b, s, nq, hd), k (b,
    s, nkv, hd), positions broadcastable to (b, s), freq (hd // 2,) fp32."""
    if q.device.type == "cpu":
        return rope_ref(q, positions, freq), rope_ref(k, positions, freq)
    qo, ko, launched = _launch(q, k, positions, freq, False, "rope_fwd")
    rope_fwd.launches += launched
    return qo, ko


rope_fwd.launches = 0


def rope_bwd(gq, gk, positions, freq):
    """The gradients of ``rope_fwd``'s q and k from those of its outputs:
    each rotated by the negated angles."""
    if gq.device.type == "cpu":
        return rope_bwd_ref(gq, positions, freq), rope_bwd_ref(gk, positions, freq)
    dq, dk, launched = _launch(gq, gk, positions, freq, True, "rope_bwd")
    rope_bwd.launches += launched
    return dq, dk


rope_bwd.launches = 0
