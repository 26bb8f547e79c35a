"""Shared building blocks: norms, rotary, FFNs, init helpers.

Params are nested dicts of tensors with the JAX package's keys and
layouts; every layer is ``init_*(gen, cfg, device) -> params`` +
``apply(params, x, ...) -> y``. The ``device`` of an init has no default:
the public entry points (``model.init_params``) choose it. Params are stored fp32 and cast to the
compute dtype on read; norms and softmax run in fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def softcap(x, cap: float):
    """gemma2-style logit soft-capping: cap * tanh(x / cap)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def scalar(value, dtype, device):
    """A 0-dim tensor of ``value`` rounded to ``dtype`` first, as
    ``jnp.asarray(value, dtype)`` does before an elementwise op."""
    return torch.tensor(float(value), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
NORM_EPS = 1e-6


def init_norm(cfg, d=None, *, device):
    d = d or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def apply_norm(params, x):
    xf = x.float()
    if "bias" in params:  # layernorm, population variance as jnp.var
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + NORM_EPS) * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + NORM_EPS) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq) int.

    Half-split rotation; the frequencies are computed in numpy float32
    exactly as the JAX twin does, then moved to x's device.
    """
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    freq = torch.from_numpy(np.asarray(freq, np.float32)).to(x.device)
    ang = positions[..., :, None].float() * freq          # (..., s, half)
    ang = ang[..., None, :]                                # (..., s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / FFN
# ---------------------------------------------------------------------------
def _winit(gen, shape, in_dim, device):
    return torch.randn(shape, generator=gen, device=device) / np.sqrt(in_dim)


def init_mlp(gen, cfg, device):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"wi": _winit(gen, (d, f), d, device),
                "wg": _winit(gen, (d, f), d, device),
                "wo": _winit(gen, (f, d), f, device)}
    return {"wi": _winit(gen, (d, f), d, device),
            "wo": _winit(gen, (f, d), f, device)}


def apply_mlp(params, x, cfg):
    dt = x.dtype
    if "wg" in params:  # swiglu
        h = F.silu(x @ params["wi"].to(dt)) * (x @ params["wg"].to(dt))
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"].to(dt), approximate="tanh")
    return h @ params["wo"].to(dt)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(gen, cfg, device):
    p = {"table": _winit(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _winit(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                              device)
    return p


def embed(params, tokens, cfg):
    # Gather, then cast: the same values as casting the table first, without
    # a compute-dtype copy of the whole table.
    x = params["table"][tokens].to(cdtype(cfg))
    if cfg.tie_embeddings:  # gemma-style scaled embeddings
        x = x * scalar(np.sqrt(cfg.d_model), x.dtype, x.device)
    return x


def unembed(params, x, cfg):
    if cfg.tie_embeddings:
        logits = x @ params["table"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    return softcap(logits.float(), cfg.final_softcap)
