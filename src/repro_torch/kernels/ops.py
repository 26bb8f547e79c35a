"""Autograd wrappers for the port's kernels.

``flash_attention``: the CUDA forward (``flash_attention.py``). Its
backward is not ported yet: the dq and dk/dv kernels are rows 2 and 3 of
ROADMAP queue B, and until they land a backward through it raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_fwd


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        return flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale,
                                   q_offset=q_offset)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash-attention backward is not ported: the dq and dk/dv "
            "kernels are ROADMAP queue B rows 2 and 3")


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0, scale=None,
                    q_offset=0):
    """``q_offset`` shifts query positions for the causal/window masks
    (sequence-sliced attention over a retained-KV prefix of that many
    keys). 0 is plain full-sequence attention."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_offset)
