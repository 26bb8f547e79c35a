"""The benchmark's inputs, made from ``--seed``: the weights and the
batches. Both sides of the check (the program and the plain reference) get
the same tensors.

Weights: fp32, in the program's parameter layout (a model module's
``param_shapes``; by default ``embed``, ``blocks`` stacked by pattern
position, ``final_norm``), drawn on the device in one
``randn`` call into a flat buffer that every leaf is a view of, then each
leaf scaled in place: a weight by 1 / sqrt(fan-in), as the program's own
init draws them; a norm's scale 1 + 0.1 n and a bias 0.1 n, so that a path
that skipped one would show.

Traffic (``traffic/<name>.json``): training batches of ``microbatches`` x
``micro_batch`` rows of ``seq_len`` token ids drawn uniformly over the
vocabulary, labels the tokens shifted by one. ``distinct_batches`` of them
are drawn in one call; step j of a run takes batch j modulo that count, so
every step of a run's set-up and window gets rows of its own.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

_MIX = 0x9E3779B97F4A7C15  # keeps a seed's weights and traffic apart
SEED_RANGE = 2**63


def generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream * _MIX) % SEED_RANGE)
    return g


def layer_shapes(cfg) -> Dict[str, Any]:
    """One layer's leaves: {path: (shape, kind)}, kind "weight:<fan-in>",
    "scale" or "bias". Attention mixers with a dense or MoE FFN."""
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    norm = lambda n=d: ({"scale": ((n,), "scale"), "bias": ((n,), "bias")}
                        if cfg.norm == "layernorm" else {"scale": ((n,), "scale")})
    w = lambda shape, fan: (shape, f"weight:{fan}")
    mixer = {"wq": w((d, nq, hd), d), "wk": w((d, nkv, hd), d),
             "wv": w((d, nkv, hd), d), "wo": w((nq, hd, d), nq * hd)}
    if cfg.qkv_bias:
        mixer.update(bq=((nq, hd), "bias"), bk=((nkv, hd), "bias"),
                     bv=((nkv, hd), "bias"))
    layer = {"norm1": norm(), "mixer": mixer}
    if cfg.moe is not None:
        e, f = cfg.moe.num_experts, cfg.moe.d_ff
        layer["norm2"] = norm()
        layer["ffn"] = {"router": w((d, e), d), "wi": w((e, d, f), d),
                        "wg": w((e, d, f), d), "wo": w((e, f, d), f)}
    elif cfg.d_ff:
        f = cfg.d_ff
        layer["norm2"] = norm()
        layer["ffn"] = {"wi": w((d, f), d), "wo": w((f, d), f)}
        if cfg.mlp_kind == "swiglu":
            layer["ffn"]["wg"] = w((d, f), d)
    return layer


def _check_supported(cfg):
    unsupported = [name for name, bad in (
        ("a mixer other than global attention", set(cfg.block_pattern) != {"attn"}),
        ("qk_norm", cfg.qk_norm), ("attn_softcap", cfg.attn_softcap),
        ("final_softcap", cfg.final_softcap), ("window_size", cfg.window_size),
        ("an encoder", cfg.encoder_layers), ("a frontend", cfg.frontend != "none"),
        ("a shared expert", cfg.moe is not None and cfg.moe.shared_expert))
        if bad]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the benchmark's reference has no {', '.join(unsupported)}")


def param_shapes(cfg) -> Dict[str, Any]:
    """The program's parameter layout for ``cfg``: {path: (shape, kind)}
    nested as the params are. Every layer is a row of ``blocks/pos0``
    (the one-mixer patterns the reference covers)."""
    _check_supported(cfg)
    d, v, n = cfg.d_model, cfg.vocab_size, cfg.num_layers
    stack = lambda tree: {k: stack(t) if isinstance(t, dict)
                          else ((n,) + t[0], t[1]) for k, t in tree.items()}
    embed = {"table": ((v, d), f"weight:{d}")}
    if not cfg.tie_embeddings:
        embed["unembed"] = ((d, v), f"weight:{d}")
    final = layer_shapes(cfg)["norm1"]
    return {"embed": embed, "blocks": {"pos0": stack(layer_shapes(cfg))},
            "final_norm": final}


def _walk(tree, prefix=()):
    for k in sorted(tree):
        t = tree[k]
        if isinstance(t, dict):
            yield from _walk(t, prefix + (k,))
        else:
            yield prefix + (k,), t


def numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def make_params(shapes: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """fp32 params of the layout ``shapes`` (a model module's
    ``param_shapes(cfg)``) on ``device`` from ``seed``."""
    leaves = list(_walk(shapes))
    total = sum(numel(shape) for _, (shape, _) in leaves)
    flat = torch.randn(total, generator=generator(seed, device, 0),
                       device=device, dtype=torch.float32)
    out: Dict[str, Any] = {}
    off = 0
    with torch.no_grad():
        for path, (shape, kind) in leaves:
            t = flat[off:off + numel(shape)].view(shape)
            off += numel(shape)
            if kind.startswith("weight:"):
                t.mul_(float(int(kind.split(":")[1])) ** -0.5)
            elif kind == "scale":
                t.mul_(0.1).add_(1.0)
            else:
                t.mul_(0.1)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
    return out


def batch_rows(traffic: Dict[str, Any]) -> int:
    return int(traffic["microbatches"]) * int(traffic["micro_batch"])


def make_batches(traffic: Dict[str, Any], vocab: int, seed: int, device
                 ) -> List[Dict[str, torch.Tensor]]:
    """``traffic["distinct_batches"]`` batches {tokens, labels}, each
    (rows, seq_len) int64, from one draw of uniform ids."""
    k, rows, s = int(traffic["distinct_batches"]), batch_rows(traffic), int(traffic["seq_len"])
    ids = torch.randint(0, vocab, (k, rows, s + 1), generator=generator(seed, device, 1),
                        device=device, dtype=torch.int64)
    return [{"tokens": ids[j, :, :-1].contiguous(), "labels": ids[j, :, 1:].contiguous()}
            for j in range(k)]


def leaf_names(cfg) -> List[Tuple[str, ...]]:
    """Every compared leaf as a path; a stacked leaf gives one per layer,
    ("layer<l>", ...)."""
    out = []
    for path, _ in _walk(param_shapes(cfg)):
        if path[0] == "blocks":
            out += [(f"layer{l}",) + path[2:] for l in range(cfg.num_layers)]
        else:
            out.append(path)
    return out


def leaf_of(tree: Dict[str, Any], name: Tuple[str, ...]) -> torch.Tensor:
    """The tensor of a compared leaf ``name`` in a tree of the program's
    layout (its params or its grads): a layer's row of a stacked leaf."""
    if name[0].startswith("layer"):
        node = tree["blocks"]["pos0"]
        for k in name[1:]:
            node = node[k]
        return node[int(name[0][len("layer"):])]
    node = tree
    for k in name:
        node = node[k]
    return node
