"""The plain reference: the loss and the gradients of one training step of a
decoder-only Transformer, in plain PyTorch and float32 with TF32 off. It
imports nothing of the program and takes from it nothing but the params
and the batch, which the benchmark made (``inputs.py``).

What it computes, for a batch of m microbatches of b rows of s tokens:

    loss = (1/m) sum_j [ mean nll of microbatch j + sum_l aux_l(j) ]

and its gradient with respect to every parameter. Each layer is a pre-norm
block: x + attention(norm1(x)), then x + ffn(norm2(x)).

  * norms: LayerNorm (population variance) or RMSNorm, eps 1e-6, in fp32;
  * attention: q, k, v projections (+ biases), half-split RoPE over
    positions 0..s-1, GQA (q head n reads kv head n // (nq / nkv)), causal
    softmax of q k^T / sqrt(hd) (over the ``window`` latest keys where a
    layer is given one), the heads merged through ``wo``;
  * dense FFN: GELU (tanh approximation) or SwiGLU;
  * MoE FFN: fp32 router softmax, top-k, the gates renormalised; each
    (token, choice) pair of a row, in token-major order, takes the next
    slot of its expert, and a pair past the capacity
    C = max(k, min(ceil(s k / E * capacity_factor), s k)) adds nothing; the
    load-balance loss E * sum_e f_e P_e * router_aux_weight (f_e the mean
    count of choices of expert e a token, P_e its mean probability, both
    over the microbatch's tokens);
  * tied embeddings scale the looked-up rows by sqrt(d) and reuse the
    table as the head.

The whole model's fp32 gradients do not fit beside the program's on one
card for the largest configuration, so the gradients are computed a layer
at a time: one forward pass keeps each layer's input for every
microbatch, then from the top down each layer is run again with autograd
and differentiated, its gradients handed out (``leaf_grads``) and freed.
``layers_loss`` and ``layers_grads`` do so over any list of layers, each a
row of a stacked parameter tree and the function that applies it, for a
model module (``bench/spec.py``) whose layout or layers differ from the
default's (``stacked_layers``: every layer a global-attention ``layer`` in
``blocks/pos0``).

``fp8=True`` is the control: the same computation with every matrix
product's operands rounded to float8 e4m3 and their gradients to e5m2, each
with a per-tensor scale, one precision below the bfloat16 the
configurations compute in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-6
LeafName = Tuple[str, ...]
Layer = Tuple[Dict[str, Any], int, Callable]   # (stacked params, row, layer fn)


@contextlib.contextmanager
def fp32_exact():
    """Float32 products without TF32 for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) = old[:2]
        torch.set_float32_matmul_precision(old[2])


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under a per-tensor scale that
    maps its largest magnitude to the format's largest, back in fp32."""
    if x.numel() == 0:
        return x
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """A product operand in float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


class Numerics:
    """The matrix products of the reference (fp32) or of the control (fp8
    operands)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def op(self, x):
        return _Fp8.apply(x) if self.fp8 else x

    def mm(self, x, w):
        return self.op(x) @ self.op(w)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------
def norm(p: Dict[str, torch.Tensor], x):
    if "bias" in p:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + EPS) * p["scale"] + p["bias"]
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + EPS) * p["scale"]


def rope(x, theta: float):
    """x (b, s, heads, hd) at positions 0..s-1, half-split rotation."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freq
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, cfg, nm: Numerics, window: int = 0):
    """Causal self attention; with ``window`` each query keeps only the
    ``window`` latest keys, itself included (i - window < j <= i)."""
    b, s, d = h.shape
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = nm.mm(h, p["wq"].reshape(d, nq * hd)).view(b, s, nq, hd)
    k = nm.mm(h, p["wk"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    v = nm.mm(h, p["wv"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))          # (b, nq, s, hd)
    scores = nm.op(q) @ nm.op(k).transpose(-1, -2) / math.sqrt(hd)
    keep = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    if window:
        keep = keep.triu(1 - window)
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    out = (nm.op(probs) @ nm.op(v)).transpose(1, 2).reshape(b, s, nq * hd)
    return nm.mm(out, p["wo"].reshape(nq * hd, d))


def mlp(p, h, cfg, nm: Numerics):
    if "wg" in p:
        a = F.silu(nm.mm(h, p["wi"])) * nm.mm(h, p["wg"])
    else:
        a = F.gelu(nm.mm(h, p["wi"]), approximate="tanh")
    return nm.mm(a, p["wo"])


def moe(p, h, cfg, nm: Numerics):
    """Returns (y, aux) for h (b, s, d)."""
    e = cfg.moe
    b, s, d = h.shape
    k, E = e.top_k, e.num_experts
    probs = torch.softmax(nm.mm(h, p["router"]), dim=-1)      # (b, s, E)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = max(k, min(math.ceil(s * k / E * e.capacity_factor), s * k))
    pairs = idx.reshape(b, s * k)                              # token-major
    # each pair's slot: the pairs of the same expert before it in its row
    onehot = F.one_hot(pairs, E)                               # (b, s k, E)
    slot = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1
    row, pair = torch.nonzero(slot < cap, as_tuple=True)      # kept pairs
    expert = pairs[row, pair]
    order = torch.argsort(expert, stable=True)                 # grouped by expert
    row, pair, expert = row[order], pair[order], expert[order]
    counts = torch.bincount(expert, minlength=E).tolist()
    tok = pair // k
    g = gates.reshape(b, s * k)[row, pair]
    xs = h[row, tok]
    outs, lo = [], 0
    for ex, n in enumerate(counts):
        xe = xs[lo:lo + n]
        a = F.silu(nm.mm(xe, p["wi"][ex])) * nm.mm(xe, p["wg"][ex])
        outs.append(nm.mm(a, p["wo"][ex]))
        lo += n
    y = torch.zeros_like(h).index_put((row, tok), torch.cat(outs) * g[:, None],
                                      accumulate=True)
    f = F.one_hot(idx, E).float().sum(2).mean((0, 1))
    aux = E * (f * probs.mean((0, 1))).sum() * e.router_aux_weight
    return y, aux


def layer(p, x, cfg, nm: Numerics, window: int = 0):
    """One block, its attention over ``window`` keys where given. Returns
    (x, aux): aux the MoE's load-balance loss, None for a dense FFN."""
    x = x + attention(p["mixer"], norm(p["norm1"], x), cfg, nm, window)
    if cfg.moe is not None:
        y, aux = moe(p["ffn"], norm(p["norm2"], x), cfg, nm)
        return x + y, aux
    return x + mlp(p["ffn"], norm(p["norm2"], x), cfg, nm), None


def embed(params, tokens, cfg):
    x = params["embed"]["table"][tokens]
    return x * math.sqrt(cfg.d_model) if cfg.tie_embeddings else x


def head_loss(final_norm, w_head, x, labels, nm: Numerics):
    logits = nm.mm(norm(final_norm, x), w_head)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None]).mean()


def _head_weight(params, cfg):
    return params["embed"]["table"].t() if cfg.tie_embeddings else params["embed"]["unembed"]


# ---------------------------------------------------------------------------
# Loss and gradients, a layer at a time
# ---------------------------------------------------------------------------
def _tree_leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _unflatten(pairs):
    out: Dict[str, Any] = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _layer_params(stack, row: int):
    """Row ``row`` of the stacked params ``stack`` as leaf tensors that need
    a gradient (views of the given params, no copy): {path: tensor} and the
    nested dict."""
    flat = {path: t[row].detach().requires_grad_(True)
            for path, t in _tree_leaves(stack)}
    return flat, _unflatten(flat.items())


def stacked_layers(cfg, params) -> List[Layer]:
    """The default layout's layers: layer l is row l of ``blocks/pos0``,
    each a global-attention ``layer``."""
    return [(params["blocks"]["pos0"], l, layer) for l in range(cfg.num_layers)]


def _micro(batch, b: int) -> List[Dict[str, torch.Tensor]]:
    rows = batch["tokens"].shape[0]
    if rows % b:
        raise ValueError(f"{rows} rows do not split into microbatches of {b}")
    return [{k: v[j:j + b] for k, v in batch.items()} for j in range(0, rows, b)]


def loss_only(cfg, params, batch, micro_batch: int, fp8: bool = False) -> float:
    """The step's loss, no gradients."""
    return layers_loss(cfg, params, stacked_layers(cfg, params), batch, micro_batch, fp8)


def leaf_grads(cfg, params, batch, micro_batch: int, fp8: bool = False
               ) -> Iterator[Tuple[LeafName, torch.Tensor]]:
    """``layers_grads`` over the default layout (``stacked_layers``); names
    as ``inputs.leaf_names``."""
    return layers_grads(cfg, params, stacked_layers(cfg, params), batch, micro_batch, fp8)


def layers_loss(cfg, params, layers: List[Layer], batch, micro_batch: int,
                fp8: bool = False) -> float:
    """The step's loss, no gradients, through ``layers`` in depth order:
    (stacked params, row, run), run(layer params, x, cfg, numerics) ->
    (x, aux), as ``layer``."""
    nm = Numerics(fp8)
    micros = _micro(batch, micro_batch)
    total = 0.0
    with torch.no_grad(), fp32_exact():
        for mb in micros:
            x = embed(params, mb["tokens"], cfg)
            for stack, row, run in layers:
                _, lp = _layer_params(stack, row)
                x, aux = run(lp, x, cfg, nm)
                if aux is not None:
                    total += float(aux)
            total += float(head_loss(params["final_norm"], _head_weight(params, cfg),
                                     x, mb["labels"], nm))
    return total / len(micros)


def layers_grads(cfg, params, layers: List[Layer], batch, micro_batch: int,
                 fp8: bool = False) -> Iterator[Tuple[LeafName, torch.Tensor]]:
    """Yields ("loss",), loss first, then (leaf name, fp32 gradient) for
    every compared leaf, from the top of the model down: the final norm,
    the head (an untied one), each layer of ``layers`` (as ``layers_loss``)
    from the last, as ("layer<l>", ...) with its leaves in sorted path
    order, the embedding table last."""
    nm = Numerics(fp8)
    micros = _micro(batch, micro_batch)
    m = len(micros)
    with fp32_exact():
        # forward: every layer's input of every microbatch
        xs: List[List[torch.Tensor]] = []
        loss = 0.0
        with torch.no_grad():
            for mb in micros:
                x = embed(params, mb["tokens"], cfg)
                ins = []
                for stack, row, run in layers:
                    ins.append(x)
                    _, lp = _layer_params(stack, row)
                    x, aux = run(lp, x, cfg, nm)
                    if aux is not None:
                        loss += float(aux) / m
                ins.append(x)
                xs.append(ins)
        # the head: its grads and the cotangent of the last layer's output
        fn = {k: v.detach().requires_grad_(True) for k, v in params["final_norm"].items()}
        w = _head_weight(params, cfg).detach().requires_grad_(True)
        cot = []
        for j, mb in enumerate(micros):
            x = xs[j][-1].detach().requires_grad_(True)
            lj = head_loss(fn, w, x, mb["labels"], nm)
            loss += float(lj.detach()) / m
            torch.autograd.backward(lj / m)
            cot.append(x.grad)
            xs[j].pop()
        yield ("loss",), torch.tensor(loss, dtype=torch.float64)
        for k in sorted(fn):
            yield ("final_norm", k), fn[k].grad
        del fn
        head_grad = w.grad.t() if cfg.tie_embeddings else None
        if not cfg.tie_embeddings:
            yield ("embed", "unembed"), w.grad
        del w
        # the layers, from the top
        for l in reversed(range(len(layers))):
            stack, row, run = layers[l]
            flat, lp = _layer_params(stack, row)
            for j in range(m):
                x = xs[j].pop().requires_grad_(True)
                y, aux = run(lp, x, cfg, nm)
                outs, grads = [y], [cot[j]]
                if aux is not None:
                    outs.append(aux)
                    grads.append(torch.full_like(aux, 1.0 / m))
                torch.autograd.backward(outs, grads)
                cot[j] = x.grad
                del x, y, aux, outs, grads
            for path in sorted(flat):
                g = flat[path].grad
                yield (f"layer{l}",) + path, g if g is not None else torch.zeros_like(flat[path])
            del flat, lp
        # the embedding
        table = params["embed"]["table"].detach().requires_grad_(True)
        for j, mb in enumerate(micros):
            x = embed({"embed": {"table": table}}, mb["tokens"], cfg)
            torch.autograd.backward(x, cot[j])
        g = table.grad
        if head_grad is not None:
            g = g + head_grad
        yield ("embed", "table"), g
