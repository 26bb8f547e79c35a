"""PatternStack: layer stacks as a loop over repeating pattern blocks.

A model's depth is ``num_layers`` layers whose temporal-mixer kinds follow
``cfg.block_pattern``. As in the JAX twin, full pattern repetitions are
stacked (every leaf has a leading ``n_full`` dim) and the remainder layers
(depth % pattern) are kept apart as ``rem{i}``; a Python loop over the
stacked rows takes the place of ``lax.scan``. The rows of the stacked
params are taken with one ``torch.unbind`` per leaf and forward: its
backward stacks the rows' grads once, where a ``select`` per row would
allocate a zero tensor of the whole stack for every row and leaf.

Recompute arms, as in the JAX twin: ``remat="attn"`` checkpoints each
layer's mixer, ``"full"`` each stacked pattern block (not the remainder
layers), both with ``torch.utils.checkpoint`` (non-reentrant).

Each layer = pre-norm mixer + pre-norm dense FFN, residual. The port covers
the attention mixers (ATTN, LOCAL); the other kinds raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, LOCAL, MLSTM, RGLRU, SLSTM
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

_NOT_PORTED = {
    RGLRU: "RG-LRU mixers are not ported yet (ROADMAP queue A, other mixers)",
    MLSTM: "xLSTM mixers are not ported yet (ROADMAP queue A, other mixers)",
    SLSTM: "xLSTM mixers are not ported yet (ROADMAP queue A, other mixers)",
}


def _check_supported(cfg, kind):
    if kind in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[kind])
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)
    if cfg.moe is not None:
        raise NotImplementedError(
            "MoE FFNs are not ported yet (ROADMAP queue A, other mixers)")


# ---------------------------------------------------------------------------
# Single-layer init / apply
# ---------------------------------------------------------------------------
def init_layer(gen, cfg, kind, device):
    _check_supported(cfg, kind)
    p: Dict[str, Any] = {"norm1": init_norm(cfg, device=device),
                         "mixer": attn_mod.init_attention(gen, cfg, device)}
    if cfg.d_ff:
        p["norm2"] = init_norm(cfg, device=device)
        p["ffn"] = init_mlp(gen, cfg, device)
    return p


def _apply_mixer(p, x, cfg, kind, positions, *, remat):
    def f(p_, x_):
        out, _ = attn_mod.attention(p_, x_, cfg, positions, kind=kind)
        return out

    if remat == "attn":
        return checkpoint(f, p, x, use_reentrant=False)
    return f(p, x)


#: Mixer kinds that can run sequence slices (seq_chunks > 1): causal
#: attention over a retained-KV prefix. The recurrent kinds carry state
#: across the sequence that a slice boundary would cut.
SLICEABLE_KINDS = (ATTN, LOCAL)


def apply_layer_sliced(p, x, cfg, kind, positions, kv_prefix, *,
                       remat="none"):
    """One layer over ONE sequence slice with a retained-KV prefix.

    Returns (x, aux_loss, (k, v)): the slice's own post-RoPE KV, which the
    pipeline executor keeps for later slices. Only attention mixers
    (``SLICEABLE_KINDS``) can slice; cross-attention layers cannot (the
    encoder states span the whole sequence).
    """
    if kind not in SLICEABLE_KINDS:
        raise ValueError(
            f"seq_chunks > 1 needs attention mixers, got {kind!r}")
    if "cross" in p:
        raise ValueError("seq_chunks > 1 does not support cross-attention")
    _check_supported(cfg, kind)

    def mix(p_, x_, pk, pv):
        return attn_mod.attention_sliced(p_, x_, cfg, positions, (pk, pv),
                                         kind=kind)

    if remat == "attn":
        h, kv = checkpoint(mix, p["mixer"], apply_norm(p["norm1"], x),
                           *kv_prefix, use_reentrant=False)
    else:
        h, kv = mix(p["mixer"], apply_norm(p["norm1"], x), *kv_prefix)
    x = x + h
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x), cfg)
    return x, 0.0, kv


def apply_layer(p, x, cfg, kind, positions, *, remat="none"):
    """Forward layer. Returns (x, aux_loss); aux is 0 for a dense FFN."""
    _check_supported(cfg, kind)
    x = x + _apply_mixer(p["mixer"], apply_norm(p["norm1"], x), cfg, kind,
                         positions, remat=remat)
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x), cfg)
    return x, 0.0


# ---- per-layer KV state ------------------------------------------------------
def init_layer_state(cfg, kind, batch, max_len, dtype, device):
    _check_supported(cfg, kind)
    return attn_mod.init_kv_cache(cfg, kind, batch, max_len, dtype, device)


def apply_layer_prefill(p, x, cfg, kind, positions, state):
    """Like apply_layer but also fills this layer's KV cache (in place)."""
    _check_supported(cfg, kind)
    h, (k, v) = attn_mod.attention(p["mixer"], apply_norm(p["norm1"], x), cfg,
                                   positions, kind=kind)
    new_state = attn_mod.fill_kv_cache(state, k, v)
    x = x + h
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x), cfg)
    return x, new_state


def apply_layer_decode(p, x, cfg, kind, pos, state):
    """One-token decode. x: (b, 1, d). Returns (x, new_state)."""
    _check_supported(cfg, kind)
    h, state = attn_mod.attention_decode(p["mixer"], apply_norm(p["norm1"], x),
                                         cfg, state, pos, kind=kind)
    x = x + h
    if "ffn" in p:
        x = x + apply_mlp(p["ffn"], apply_norm(p["norm2"], x), cfg)
    return x, state


# ---------------------------------------------------------------------------
# Nested-dict helpers
# ---------------------------------------------------------------------------
def _row(tree, i):
    """Row ``i`` of every stacked leaf (views, so writes reach the stack)."""
    return {k: _row(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _rows(tree, n):
    """The ``n`` rows of every stacked leaf, as ``n`` trees of views."""
    out = [{} for _ in range(n)]
    for k, v in tree.items():
        parts = _rows(v, n) if isinstance(v, dict) else torch.unbind(v)
        for row, part in zip(out, parts):
            row[k] = part
    return out


def _stack_init(n: int, make: Callable[[], Dict[str, Any]]):
    """Stack ``n`` results of ``make()`` along a new leading dim, filling a
    preallocated tensor row by row so the peak is one stack plus one layer."""
    first = make()

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i].copy_(v)

    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make(), i)
    return out


# ---------------------------------------------------------------------------
# PatternStack
# ---------------------------------------------------------------------------
class PatternStack:
    """How cfg.num_layers decompose into stacked cfg.block_pattern blocks +
    remainder layers, and the loops that run them."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pattern = tuple(cfg.block_pattern)
        n = cfg.num_layers
        self.n_full = n // len(self.pattern)
        self.rem = self.pattern[: n % len(self.pattern)]

    # -- init ---------------------------------------------------------------
    def init(self, gen, device):
        p = {}
        for j, kind in enumerate(self.pattern):
            if self.n_full:
                p[f"pos{j}"] = _stack_init(
                    self.n_full,
                    lambda: init_layer(gen, self.cfg, kind, device))
        for i, kind in enumerate(self.rem):
            p[f"rem{i}"] = init_layer(gen, self.cfg, kind, device)
        return p

    def init_state(self, batch, max_len, dtype, device):
        st = {}
        for j, kind in enumerate(self.pattern):
            if self.n_full:
                st[f"pos{j}"] = _stack_init(
                    self.n_full, lambda: init_layer_state(
                        self.cfg, kind, batch, max_len, dtype, device))
        for i, kind in enumerate(self.rem):
            st[f"rem{i}"] = init_layer_state(self.cfg, kind, batch, max_len,
                                             dtype, device)
        return st

    def _blocks(self, params):
        """The params of each stacked pattern block: {pos{j}: layer params}."""
        rows = {f"pos{j}": _rows(params[f"pos{j}"], self.n_full)
                for j in range(len(self.pattern)) if self.n_full}
        return [{k: v[r] for k, v in rows.items()} for r in range(self.n_full)]

    def _layers(self, params, state=None):
        """(kind, layer params, layer state) in depth order."""
        for r, block in enumerate(self._blocks(params)):
            for j, kind in enumerate(self.pattern):
                yield (kind, block[f"pos{j}"],
                       None if state is None else _row(state[f"pos{j}"], r))
        for i, kind in enumerate(self.rem):
            yield (kind, params[f"rem{i}"],
                   None if state is None else state[f"rem{i}"])

    # -- train / eval forward ----------------------------------------------------
    def apply(self, params, x, positions, *, remat="none"):
        cfg, pattern = self.cfg, self.pattern

        def block(x, block_params):
            aux = 0.0
            for j, kind in enumerate(pattern):
                x, a = apply_layer(block_params[f"pos{j}"], x, cfg, kind,
                                   positions, remat=remat)
                aux = aux + a
            return x, aux

        aux = 0.0
        for block_params in self._blocks(params):
            if remat == "full":
                x, a = checkpoint(block, x, block_params, use_reentrant=False)
            else:
                x, a = block(x, block_params)
            aux = aux + a
        for i, kind in enumerate(self.rem):
            x, a = apply_layer(params[f"rem{i}"], x, cfg, kind, positions,
                               remat=remat)
            aux = aux + a
        return x, aux

    # -- prefill (forward + fill decode state) ----------------------------------
    def prefill(self, params, x, positions, state):
        """Returns (x, state); the state's tensors are filled in place."""
        for kind, p, st in self._layers(params, state):
            x, _ = apply_layer_prefill(p, x, self.cfg, kind, positions, st)
        return x, state

    # -- one-token decode --------------------------------------------------------
    def decode(self, params, x, pos, state):
        """Returns (x, state); the state's tensors are updated in place."""
        for kind, p, st in self._layers(params, state):
            x, _ = apply_layer_decode(p, x, self.cfg, kind, pos, st)
        return x, state
