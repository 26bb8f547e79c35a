"""Plain-torch versions of the port's kernels (twins of the JAX package's
``kernels/ref.py``): the CPU path of each kernel's wrapper and the oracle
the kernel is held against on the card."""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)


def _scores(qr, k, *, causal, window, softcap, scale, q_offset):
    """The masked fp32 scores S (b, g, m, q, k) of qr (b, sq, nkv, m, hd)
    against k, and dS's softcap factor dcap = 1 - tanh^2 (1.0 without one)."""
    sq, sk = qr.shape[1], k.shape[1]
    s = torch.einsum("bqgmh,bkgh->bgmqk", qr, k.float()) * scale
    dcap = 1.0
    if softcap:
        t = torch.tanh(s / softcap)
        s = softcap * t
        dcap = 1.0 - t * t
    qpos = torch.arange(sq, device=qr.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=qr.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=qr.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return torch.where(mask, s, NEG_INF), dcap


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
    nkv = k.shape[2]
    m = nq // nkv
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    s, _ = _scores(q.reshape(b, sq, nkv, m, hd).float(), k, causal=causal,
                   window=window, softcap=softcap, scale=scale,
                   q_offset=q_offset)
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


def flash_attention_delta(out, dout, lse):
    """D = rowsum(dO * O) in fp32, shaped as the LSE (b, sq, nkv, m)."""
    return (dout.float() * out.float()).sum(-1).reshape(lse.shape)


def _p_ds(q, k, v, lse, delta, dout, *, causal, window, softcap, scale,
          q_offset):
    """What both backward passes recompute: q and dO as (b, sq, nkv, m, hd)
    fp32, P = exp(S - LSE) and dS = P (dP - D) dcap scale, (b, g, m, q, k)."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    m = nq // nkv
    qr = q.reshape(b, sq, nkv, m, hd).float()
    dor = dout.reshape(b, sq, nkv, m, hd).float()
    s, dcap = _scores(qr, k, causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset)
    p = torch.exp(s - lse.permute(0, 2, 3, 1)[..., None])
    dp = torch.einsum("bqgmh,bkgh->bgmqk", dor, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * dcap * scale
    return qr, dor, p, ds


def flash_attention_dq_ref(q, k, v, lse, delta, dout, *, causal=True,
                           window=0, softcap=0.0, scale=None, q_offset=0):
    """The dq kernel's function: dQ = dS K in q's dtype, from the forward's
    LSE and D = ``flash_attention_delta``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    _, _, _, ds = _p_ds(q, k, v, lse, delta, dout, causal=causal,
                        window=window, softcap=softcap, scale=scale,
                        q_offset=q_offset)
    dq = torch.einsum("bgmqk,bkgh->bqgmh", ds, k.float())
    return dq.reshape(q.shape).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, lse, delta, dout, *, causal=True,
                            window=0, softcap=0.0, scale=None, q_offset=0):
    """The dk/dv kernel's function: dK = dS^T Q and dV = P^T dO, each summed
    over the m query heads of its kv head, in k's and v's dtypes."""
    scale = scale if scale is not None else 1.0 / np.sqrt(q.shape[-1])
    qr, dor, p, ds = _p_ds(q, k, v, lse, delta, dout, causal=causal,
                           window=window, softcap=softcap, scale=scale,
                           q_offset=q_offset)
    dk = torch.einsum("bgmqk,bqgmh->bkgh", ds, qr)
    dv = torch.einsum("bgmqk,bqgmh->bkgh", p, dor)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, window=0,
                            softcap=0.0, scale=None, q_offset=0):
    """The flash backward's function: (dq, dk, dv) from the forward's O and
    LSE (b, sq, nkv, m), in fp32 over the full (sq, sk) scores, as the two
    kernels split it: D, then the dq pass, then the dk/dv pass.

    P = exp(S - LSE) over the masked (and soft-capped) scores, dV = P^T dO,
    dP = dO V^T, D = rowsum(dO * O), dS = P (dP - D) dcap scale with
    dcap = 1 - tanh^2 under a softcap, dQ = dS K, dK = dS^T Q; dK and dV sum
    over the m query heads of each kv head. dq comes back in q's dtype, dk
    and dv in k's and v's.
    """
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    delta = flash_attention_delta(out, dout, lse)
    dq = flash_attention_dq_ref(q, k, v, lse, delta, dout, **kw)
    return (dq, *flash_attention_dkv_ref(q, k, v, lse, delta, dout, **kw))


def fused_softmax_ref(x, *, scale=1.0, causal=False):
    """The fused softmax forward kernel's function on x (..., sq, sk): fp32
    upcast, scale, the causal mask (square scores) to NEG_INF, a
    max-subtracted softmax, downcast to x's dtype."""
    xf = x.float() * scale
    if causal:
        sq, sk = x.shape[-2:]
        mask = (torch.arange(sq, device=x.device)[:, None]
                >= torch.arange(sk, device=x.device)[None, :])
        xf = torch.where(mask, xf, NEG_INF)
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def fused_softmax_bwd_ref(y, dy, *, scale=1.0):
    """The fused softmax backward kernel's function: dx = y (dy - sum(y dy))
    scale over the last axis, in fp32, downcast to y's dtype."""
    yf, dyf = y.float(), dy.float()
    dot = (yf * dyf).sum(-1, keepdim=True)
    return ((yf * (dyf - dot)) * scale).to(y.dtype)


def _angles(positions, freq):
    """cos and sin of positions x freq, (..., s, 1, half) fp32."""
    ang = positions[..., :, None].float() * freq          # (..., s, half)
    ang = ang[..., None, :]                                # (..., s, 1, half)
    return torch.cos(ang), torch.sin(ang)


def rope_ref(x, positions, freq):
    """The rope kernel's function on x (..., s, heads, hd): the half-split
    rotation by positions (..., s) x freq (hd // 2,) fp32, products and sums
    in fp32, rounded once to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = _angles(positions, freq)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_bwd_ref(g, positions, freq):
    """The rope kernel's backward: the gradient g of ``rope_ref``'s output
    rotated by the negated angles, in fp32, rounded once to g's dtype."""
    half = g.shape[-1] // 2
    cos, sin = _angles(positions, freq)
    g1, g2 = g[..., :half], g[..., half:]
    out = torch.cat([g1 * cos + g2 * sin, g2 * cos - g1 * sin], dim=-1)
    return out.to(g.dtype)
