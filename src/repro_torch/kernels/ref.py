"""Plain-torch versions of the port's kernels (twins of the JAX package's
``kernels/ref.py``): the CPU path of each kernel's wrapper and the oracle
the kernel is held against on the card."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, q_offset=0, return_lse=False):
    """q: (b, sq, nq, hd); k/v: (b, sk, nkv, hd), nq % nkv == 0.
    ``q_offset``: query row i sits at global position i + q_offset
    (sequence-sliced attention over a retained-KV prefix).

    The flash kernel's function: fp32 scores and products, masked with
    NEG_INF, O = (P V) / max(l, 1e-30) cast to the input dtype, and with
    ``return_lse`` also LSE = max + log(max(l, 1e-30)), (b, sq, nkv, m) fp32.
    """
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    m = nq // nkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    qr = q.reshape(b, sq, nkv, m, hd).float()
    s = torch.einsum("bqgmh,bkgh->bgmqk", qr, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bgmqk,bkgh->bqgmh", p, v.float()) \
        / denom.permute(0, 3, 1, 2, 4)
    out = out.reshape(b, sq, nq, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = (mx + torch.log(denom))[..., 0].permute(0, 3, 1, 2)  # (b, sq, g, m)
    return out, lse.contiguous()
