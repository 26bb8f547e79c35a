"""Shared building blocks: norms, rotary, FFNs, init helpers.

Params are nested dicts of tensors with the JAX package's keys and
layouts; every layer is ``init_*(gen, cfg, device) -> params`` +
``apply(params, x, ...) -> y``. The ``device`` of an init has no default:
the public entry points (``model.init_params``) choose it. Params are stored fp32 and cast to the
compute dtype on read; norms and softmax run in fp32. Every weight product
goes through ``cast_matmul``, which saves the fp32 weight for the backward
and casts it again there, so no compute-dtype copy of a weight is held
between a forward and its backward; ``cast_bmm`` does the same for the
MoE's expert-stacked weights.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rope_ref
from repro_torch.kernels.rope import freqs as rope_freqs
from repro_torch.obs.ranges import span


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class _CastMatmul(torch.autograd.Function):
    """``x @ w.to(x.dtype)`` as matmul folds it (x to rows, one ``mm``),
    saving ``w`` itself for the backward. The backward casts ``w`` again
    and runs the ``mm`` backward that autograd runs for the product (which
    takes grad_w transposed when the cast weight is column-major), then
    casts grad_w to ``w``'s dtype as the cast's own backward does: the same
    values, without the cast copy among the saved tensors. Each cast opens
    the profiler range "cast" (``obs.ranges``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with span("cast"):
            wc = w.to(x.dtype)
        return _view_rows(_rows(x).mm(wc), (*x.shape[:-1], w.shape[-1]))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with span("cast"):
            wc = w.to(x.dtype)
        rows, g2 = _rows(x), _rows(g)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _view_rows(g2.mm(wc.t()), x.shape)
        if ctx.needs_input_grad[1]:
            if wc.stride(0) == 1 and wc.stride(1) == wc.shape[0]:
                gw = g2.t().mm(rows).t()
            else:
                gw = rows.t().mm(g2)
            with span("cast"):
                gw = gw.to(w.dtype)
        return gx, gw


def _rows(t):
    """``t`` (..., n) as rows (prod(...), n). A DTensor sharded on a dim
    between the first and the last (a dim that the rows merge as a minor
    one, which no plain shard expresses) has those shards gathered first,
    the move recorded (``rules.redistribute``): DTensor's rules shard a
    replicated batch's sequence for free in a backward's elementwise op."""
    if type(t) is torch.Tensor:  # no import on the plain path
        return t.reshape(-1, t.shape[-1])
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        from repro_torch.sharding import rules
        inner = [p.is_shard() and 0 < p.dim < t.ndim - 1 for p in t.placements]
        if any(inner):
            t = rules.redistribute(t, [Replicate() if r else p for r, p in
                                       zip(inner, t.placements)], "rows_merge")
    return t.reshape(-1, t.shape[-1])


def _view_rows(t, shape):
    """``t.view(shape)`` for rows ``t`` (prod(shape[:-1]), n). DTensor takes
    a shard of the rows as a shard of ``shape[0]``, and may have sharded
    them over mesh dims that ``shape[0]`` does not divide (its rules shard a
    replicated operand's rows for free): those are gathered first, the move
    recorded (``rules.redistribute``)."""
    if type(t) is torch.Tensor:
        return t.view(shape)
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        from repro_torch.sharding import rules
        rows = [p.is_shard() and p.dim == 0 for p in t.placements]
        n = 1
        for i, r in enumerate(rows):
            n *= t.device_mesh.size(i) if r else 1
        if shape[0] % n:
            t = rules.redistribute(t, [Replicate() if r else p for r, p in
                                       zip(rows, t.placements)], "rows_view")
    return t.view(shape)


def cast_matmul(x, w):
    """``x @ w.to(x.dtype)`` for x (..., k) and a 2-D weight w (k, n),
    whose backward saves the fp32 ``w`` rather than its compute-dtype copy."""
    return _CastMatmul.apply(x, w)


class _CastBmm(torch.autograd.Function):
    """``torch.bmm(x, w.to(x.dtype))`` for expert-stacked weights, saving
    ``w`` itself for the backward as ``_CastMatmul`` does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with span("cast"):
            wc = w.to(x.dtype)
        return torch.bmm(x, wc)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with span("cast"):
            wc = w.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.bmm(g, wc.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            gw = torch.bmm(x.transpose(1, 2), g)
            with span("cast"):
                gw = gw.to(w.dtype)
        return gx, gw


def cast_bmm(x, w):
    """The batched ``cast_matmul``: x (E, n, k) and an expert-stacked weight
    w (E, k, f) give (E, n, f), the einsum "end,edf->enf" of x with
    ``w.to(x.dtype)``; the backward saves the fp32 ``w``, not its copy."""
    return _CastBmm.apply(x, w)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, ``fn`` of each
    rank's local values (a partial sum summed first), for the ops DTensor
    has no sharding rule for (``log_sigmoid``)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return fn(x)
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    x = x.redistribute(x.device_mesh, pl)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, pl,
                              run_check=False)


def gather_dims(t, dims, tag=None):
    """DTensor ``t`` with every shard of a dim in ``dims`` gathered and any
    partial sum summed (those mesh dims replicated): for a reshape that
    merges such a dim into the one before it, which no plain shard
    expresses, or an op over such a dim (a norm), for which
    DTensor would otherwise shard the sequence; ``t`` itself otherwise.
    With a ``tag`` the move is recorded (``rules.redistribute``)."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.sharding import rules
    whole = lambda p: p.is_partial() or (p.is_shard() and p.dim in dims)
    if not isinstance(t, DTensor) or not any(whole(p) for p in t.placements):
        return t
    want = [Replicate() if whole(p) else p for p in t.placements]
    if tag is not None:
        return rules.redistribute(t, want, tag)
    return t.redistribute(t.device_mesh, want)


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
    xf = gather_dims(x.float(), (x.ndim - 1,))  # a DTensor's features whole
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

    Half-split rotation, the plain chain (``kernels.ref.rope_ref``); the
    frequencies are the JAX twin's numpy float32 values, kept on x's device
    (``kernels.rope.freqs``).
    """
    return rope_ref(x, positions, rope_freqs(theta, x.shape[-1] // 2, x.device))


def rope_qk(q, k, positions, theta: float):
    """``rope`` of q (b, s, nq, hd) and of k (b, s, nkv, hd) at the same
    positions (b, s), on plain tensors (``attention._rope`` takes a
    DTensor's local ones). CUDA tensors go to the kernel, one launch a
    direction for both (``ops.rope_qk``), which raises before a launch on
    an input it cannot take; CPU tensors take the plain chain. Both open
    the profiler range "rope"."""
    if q.is_cuda:
        return ops.rope_qk(q, k, positions, theta)
    with span("rope"):
        return rope(q, positions, theta), rope(k, positions, theta)


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
    if "wg" in params:  # swiglu
        h = F.silu(cast_matmul(x, params["wi"])) * cast_matmul(x, params["wg"])
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(cast_matmul(x, params["wi"]), approximate="tanh")
    return cast_matmul(h, params["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embed(gen, cfg, device):
    p = {"table": _winit(gen, (cfg.vocab_size, cfg.d_model), cfg.d_model, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _winit(gen, (cfg.d_model, cfg.vocab_size), cfg.d_model,
                              device)
    return p


def _embed_sharded(table, tokens, dtype):
    """The embedding gather of a DTensor table (the sharded step), by hand
    on each rank's shards: a rank looks up the tokens of its batch rows that
    fall in its vocab rows (zeros elsewhere) and the ranks' rows are summed
    over the vocab-sharded mesh dims, in the compute dtype (one rank holds
    each row, so the sum is exact). PyTorch's own sharding rules for the
    gather and its backward differ between releases and fail on some."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.sharding.rules import local_range
    mesh = table.device_mesh
    # tokens sharded past their batch dim (a batch the data axes do not
    # divide, relocated by the rules) are gathered: each rank then looks up
    # whole rows
    tokens = gather_dims(tokens, tuple(range(1, tokens.ndim)))
    lo, hi = local_range(table.shape[0], mesh, table.placements, 0)
    grad_pl, out_pl = [], []
    for pt, pi in zip(table.placements, tokens.placements):
        if pi == Shard(0):  # the batch rows: a partial sum of the table's grad
            assert pt.is_replicate(), (table.placements, tokens.placements)
            grad_pl.append(Partial())
            out_pl.append(Shard(0))
        else:
            grad_pl.append(pt)
            out_pl.append({Shard(0): Partial(), Shard(1): Shard(2)}.get(
                pt, Replicate()))
    rows = tokens.to_local().long()
    local = table.to_local(grad_placements=grad_pl)
    inside = (rows >= lo) & (rows < hi)
    x = local[(rows - lo).clamp(0, hi - lo - 1)].to(dtype)
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=dtype,
                                                      device=x.device))
    x = DTensor.from_local(x, mesh, out_pl, run_check=False)
    return x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                 for p in out_pl])


def embed(params, tokens, cfg):
    # Gather, then cast: the same values as casting the table first, without
    # a compute-dtype copy of the whole table.
    from torch.distributed.tensor import DTensor
    table = params["table"]
    x = (_embed_sharded(table, tokens, cdtype(cfg))
         if isinstance(table, DTensor) else table[tokens].to(cdtype(cfg)))
    if cfg.tie_embeddings:  # gemma-style scaled embeddings
        x = x * scalar(np.sqrt(cfg.d_model), x.dtype, x.device)
    return x


def unembed(params, x, cfg):
    w = params["table"].T if cfg.tie_embeddings else params["unembed"]
    logits = cast_matmul(_head_input(x, w), w)
    return softcap(logits.float(), cfg.final_softcap)


def _head_input(x, w):
    """DTensor x whole over each mesh dim that shards the head's vocab
    (column) dim, as the rules' activations are (batch over the data axes,
    whole over "model"), so that the logits come out vocab-sharded: a layer
    that ran on local rows leaves x's rows sharded over "model" too, and
    DTensor would then gather the head's weight and make every rank's
    logits a partial sum over the whole vocab. The move is recorded
    (``rules.redistribute``); x as it is otherwise."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import rules
    want = [Replicate() if pw == Shard(1) else px
            for px, pw in zip(x.placements, w.placements)]
    if want == list(x.placements):
        return x
    return rules.redistribute(x, want, "head_input")
