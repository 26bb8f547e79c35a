"""Autograd wrappers for the port's kernels.

``flash_attention``: the CUDA forward (``flash_attention.flash_attention_fwd``)
saving O and the LSE, and the two-pass CUDA backward
(``flash_attention.flash_attention_bwd``: the dq and dk/dv kernels) that
recomputes P from them, the twin of the JAX package's ``custom_vjp``.

``fused_softmax``: the CUDA fused scale-mask-softmax forward saving y and
the CUDA backward (``fused_softmax.fused_softmax_fwd`` / ``_bwd``).
``unfused_softmax_chain`` is not a kernel: it is the staged baseline the
fused op is held against (upcast, scale, mask, softmax, downcast as separate
torch ops), the paper's exp-(7) chain.

``rope_qk``: the rotary embedding of q and k in one CUDA launch a direction
(``rope.rope_fwd`` / ``rope_bwd``), saving only the positions; each
direction opens the profiler range "rope" (``obs.ranges``).

On CPU tensors the kernels' wrappers take their plain PyTorch versions.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.fused_softmax import (fused_softmax_bwd,
                                               fused_softmax_fwd)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.kernels.rope import freqs, rope_bwd, rope_fwd
from repro_torch.obs.ranges import span


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       q_offset=q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale, q_offset=q_offset)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        if grad_out.stride(-1) != 1:  # the kernels take strides, not this one
            grad_out = grad_out.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, grad_out,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0, scale=None,
                    q_offset=0):
    """``q_offset`` shifts query positions for the causal/window masks
    (sequence-sliced attention over a retained-KV prefix of that many
    keys). 0 is plain full-sequence attention."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_offset)


class _RopeQK(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, positions, theta):
        with span("rope"):
            q, k = rope_fwd(q, k, positions, freqs(theta, q.shape[-1] // 2,
                                                   q.device))
        ctx.save_for_backward(positions)
        ctx.theta = theta
        return q, k

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_q, grad_k):
        (positions,) = ctx.saved_tensors
        with span("rope"):
            dq, dk = rope_bwd(grad_q, grad_k, positions, freqs(
                ctx.theta, grad_q.shape[-1] // 2, grad_q.device))
        return dq, dk, None, None


def rope_qk(q, k, positions, theta):
    """q (b, s, nq, hd) and k (b, s, nkv, hd) rotated by positions (b, s)
    at base ``theta``; the backward recomputes the angles."""
    return _RopeQK.apply(q, k, positions, theta)


class _FusedSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, causal):
        y = fused_softmax_fwd(x, scale=scale, causal=causal)
        ctx.save_for_backward(y)
        ctx.scale = scale
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return fused_softmax_bwd(y, grad, scale=ctx.scale), None, None


def fused_softmax(x, scale=1.0, causal=False):
    """x: (..., sq, sk) attention scores; fused upcast+scale+mask+softmax."""
    if causal:
        assert x.shape[-2] == x.shape[-1], \
            "causal fused softmax expects square scores"
    return _FusedSoftmax.apply(x, scale, causal)


def unfused_softmax_chain(x, scale=1.0, causal=False):
    """The paper's exp-(7) *unfused* chain, staged as separate ops (upcast,
    scale, mask, softmax, downcast): the baseline the fused kernel is
    compared against."""
    xf = x.float()
    xf = xf * scale
    if causal:
        sq, sk = x.shape[-2:]
        mask = (torch.arange(sq, device=x.device)[:, None]
                >= torch.arange(sk, device=x.device)[None, :])
        xf = torch.where(mask, xf, NEG_INF)
    y = torch.softmax(xf, dim=-1)
    return y.to(x.dtype)
