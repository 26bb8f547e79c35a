"""Autograd wrappers for the port's kernels.

``flash_attention``: the CUDA forward (``flash_attention.flash_attention_fwd``)
saving O and the LSE, and the two-pass CUDA backward
(``flash_attention.flash_attention_bwd``: the dq and dk/dv kernels) that
recomputes P from them, the twin of the JAX package's ``custom_vjp``. On
CPU tensors both take their plain PyTorch versions.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)


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
