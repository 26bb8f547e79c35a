"""A model module for the CPU tests (``bench/spec.py`` has the contract):
a decoder of ``(local_attn, attn)`` blocks, the default's layers otherwise,
which the default module refuses (its layout has one pattern position and
its reference no window).

Layout: two pattern positions, each a stack of num_layers / 2 rows;
layer l is row l // 2 of ``blocks/pos<l % 2>``. The windowed layers are
``pos0``'s. Reference: ``reference.layer`` with a window mask on them."""
import dataclasses
import functools

from bench import inputs, reference
from bench.flops import flops_per_token  # noqa: F401

PATTERN = ("local_attn", "attn")

TINY_MODEL = dict(name="windowed", num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=97, block_pattern=list(PATTERN),
                  window_size=8, moe=None)
# CPU readings at this size (bf16 program, fp32 reference), lower / upper:
# the program at most loss 6.7e-4, norm gap 6.9e-3, diff 0.033 over 32
# seeds; the control at least 0.028 (gap) and 0.31 (diff) over 19, which
# fail it. Its loss does not separate (2.2e-4 on one seed, 3.2e-3 to
# 6.6e-3 on the others), so the loss limit's upper reading is the stale
# step's, at least 0.027 over 3 (half the batch: 5.2e-3).
TINY_LIMITS = {"loss_rel": 1e-3, "grad_norm_gap": 0.02, "grad_diff": 0.08}


def param_shapes(cfg):
    if tuple(cfg.block_pattern) != PATTERN or cfg.num_layers % 2 or not cfg.window_size:
        raise NotImplementedError(f"{cfg.name}: not whole {PATTERN} blocks with a window")
    half = dataclasses.replace(cfg, num_layers=cfg.num_layers // 2, block_pattern=("attn",),
                               window_size=0)
    shapes = inputs.param_shapes(half)
    shapes["blocks"]["pos1"] = shapes["blocks"]["pos0"]
    return shapes


def leaf_names(cfg):
    out = []
    for path, _ in inputs._walk(param_shapes(cfg)):
        if path[0] == "blocks":
            pos = int(path[1][len("pos"):])
            out += [(f"layer{l}",) + path[2:] for l in range(pos, cfg.num_layers, 2)]
        else:
            out.append(path)
    return out


def leaf_of(tree, name):
    if not name[0].startswith("layer"):
        return inputs.leaf_of(tree, name)
    l = int(name[0][len("layer"):])
    node = tree["blocks"][f"pos{l % 2}"]
    for k in name[1:]:
        node = node[k]
    return node[l // 2]


def _layers(cfg, params):
    return [(params["blocks"][f"pos{l % 2}"], l // 2,
             functools.partial(reference.layer, window=0 if l % 2 else cfg.window_size))
            for l in range(cfg.num_layers)]


def leaf_grads(cfg, params, batch, micro_batch, fp8=False):
    return reference.layers_grads(cfg, params, _layers(cfg, params), batch, micro_batch, fp8)


def loss_only(cfg, params, batch, micro_batch, fp8=False):
    return reference.layers_loss(cfg, params, _layers(cfg, params), batch, micro_batch, fp8)

