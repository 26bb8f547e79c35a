"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU. The twin
of the JAX package's ``repro/models/recurrent.py``.

RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t + b_a)              (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)              (input gate)
    log a_t = -c * softplus(Lambda) * r_t     (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates run in fp32 (the fp32 products of ``_gates`` run in full fp32 on
a card: TF32 stays off). The recurrence over a whole sequence is a
log-depth scan in plain torch (``linear_scan``), where the twin takes
``lax.associative_scan``: log2(s) rounds of a few elementwise launches over
the sequence, not one launch a time step. Its backward is the same scan run
backwards, and it saves only the decays and the states. Decoding is the
single-step update. Block layout follows Griffin: two branches (conv +
RG-LRU | GeLU gate), merged multiplicatively, projected back to d_model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.models.layers import _winit, cast_matmul
from repro_torch.obs.ranges import span

_C = 8.0


def init_rglru_block(gen, cfg, device):
    d, w = cfg.d_model, cfg.rnn_width
    # Lambda init so that a = sigmoid(Lambda)^c is in ~(0.9, 0.999)
    u = torch.rand((w,), generator=gen, device=device) * 0.099 + 0.9
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u / c)
    return {
        "in_x": _winit(gen, (d, w), d, device),       # recurrent branch
        "in_g": _winit(gen, (d, w), d, device),       # gate branch
        "out": _winit(gen, (w, d), w, device),
        "conv_w": torch.randn((cfg.conv_width, w), generator=gen,
                              device=device) * 0.1,
        "conv_b": torch.zeros((w,), device=device),
        "wa": _winit(gen, (w, w), w, device),
        "ba": torch.zeros((w,), device=device),
        "wx": _winit(gen, (w, w), w, device),
        "bx": torch.zeros((w,), device=device),
        "lam": lam,
    }


def _softplus(x):
    """``jax.nn.softplus`` (log(1 + e^x) as logaddexp, no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, x):
    """a (decay, fp32) and gated input for the recurrence."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["wa"] + p["ba"])
    i = torch.sigmoid(xf @ p["wx"] + p["bx"])
    log_a = -_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * xf)
    return a, gated


def _scan(a, x):
    """h_t = a_t h_{t-1} + x_t along dim 1 from h_{-1} = 0, by doubling:
    after the round of stride d, each position holds the composition of the
    2d steps ending at it (Hillis-Steele)."""
    s, d = a.shape[1], 1
    while d < s:
        x = torch.cat([x[:, :d], torch.addcmul(x[:, d:], a[:, d:], x[:, :-d])], 1)
        if 2 * d < s:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1)
        d *= 2
    return x


class _LinearScan(torch.autograd.Function):
    """The scan with its own backward: dx_t = g_t + a_{t+1} dx_{t+1} (the
    scan reversed) and da_t = dx_t h_{t-1}; saves a and h only."""

    @staticmethod
    def forward(ctx, a, x):
        h = _scan(a, x)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
        dx = _scan(a_next.flip(1), g.flip(1)).flip(1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        return dx * h_prev, dx


def linear_scan(a, x):
    """h (b, s, w) of h_t = a_t h_{t-1} + x_t, h_{-1} = 0, for a and x
    (b, s, w): the associative scan of the twin, in log2(s) rounds. A
    profiler sees its forward as the range "rglru_scan" and its backward
    as "_LinearScanBackward"."""
    with span("rglru_scan"):
        return _LinearScan.apply(a, x)


def rglru_scan(p, x):
    """Full-sequence RG-LRU. x: (b, s, w)."""
    a, gated = _gates(p, x)
    return linear_scan(a, gated).to(x.dtype)


def rglru_step(p, x, h_prev):
    """One decode step. x: (b, w); h_prev: (b, w) fp32."""
    a, gated = _gates(p, x[:, None, :])
    h = a[:, 0] * h_prev + gated[:, 0]
    return h.to(x.dtype), h


def _conv_full(p, x):
    """Causal depthwise conv, width cw. x: (b, s, w)."""
    cw = p["conv_w"].shape[0]
    out = x * p["conv_w"][cw - 1].to(x.dtype)
    for i in range(1, cw):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * p["conv_w"][cw - 1 - i].to(x.dtype)
    return out + p["conv_b"].to(x.dtype)


def _conv_step(p, x, conv_state):
    """x: (b, w); conv_state: (b, cw-1, w) holding previous inputs."""
    window = torch.cat([conv_state, x[:, None, :]], 1)         # (b, cw, w)
    out = torch.einsum("bcw,cw->bw", window, p["conv_w"].to(x.dtype))
    out = out + p["conv_b"].to(x.dtype)
    return out, window[:, 1:]


def init_rglru_state(cfg, batch, dtype, device):
    return {
        "h": torch.zeros((batch, cfg.rnn_width), device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                            dtype=dtype, device=device),
    }


def apply_rglru_block(p, x, cfg):
    """Train/prefill path. x: (b, s, d) -> (b, s, d)."""
    u = cast_matmul(x, p["in_x"])
    g = F.gelu(cast_matmul(x, p["in_g"]), approximate="tanh")
    h = rglru_scan(p, _conv_full(p, u))
    return cast_matmul(h * g, p["out"])


def apply_rglru_block_step(p, x, cfg, state):
    """Decode path. x: (b, 1, d) -> ((b, 1, d), state), the state updated in
    place."""
    x1 = x[:, 0]
    u = cast_matmul(x1, p["in_x"])
    g = F.gelu(cast_matmul(x1, p["in_g"]), approximate="tanh")
    u, conv = _conv_step(p, u, state["conv"])
    # a copy of h: the product saves it, and the state is written below
    h, hf = rglru_step(p, u, state["h"].clone())
    out = cast_matmul(h * g, p["out"])
    state["conv"].copy_(conv)
    state["h"].copy_(hf)
    return out[:, None], state
