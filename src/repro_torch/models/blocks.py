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

Each layer = pre-norm mixer (ATTN, LOCAL, RGLRU, MLSTM or SLSTM) + an
optional pre-norm cross attention over the encoder's states (the decoder of
an encoder-decoder) + pre-norm FFN (dense or MoE), residual; a layer
returns its MoE aux loss beside x (0 for a dense FFN or none).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, LOCAL, MLSTM, RGLRU, SLSTM
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, cast_matmul,
                                       init_mlp, init_norm)


# ---------------------------------------------------------------------------
# Single-layer init / apply
# ---------------------------------------------------------------------------
def init_layer(gen, cfg, kind, device, *, cross=False):
    p: Dict[str, Any] = {"norm1": init_norm(cfg, device=device)}
    if kind in (ATTN, LOCAL):
        p["mixer"] = attn_mod.init_attention(gen, cfg, device)
    elif kind == RGLRU:
        p["mixer"] = rec_mod.init_rglru_block(gen, cfg, device)
    elif kind == MLSTM:
        p["mixer"] = xlstm_mod.init_mlstm(gen, cfg, device)
    elif kind == SLSTM:
        p["mixer"] = xlstm_mod.init_slstm(gen, cfg, device)
    else:
        raise ValueError(kind)
    if cross:
        p["norm_x"] = init_norm(cfg, device=device)
        p["cross"] = attn_mod.init_attention(gen, cfg, device, cross=True)
    if cfg.moe is not None:
        p["norm2"] = init_norm(cfg, device=device)
        p["ffn"] = moe_mod.init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["norm2"] = init_norm(cfg, device=device)
        p["ffn"] = init_mlp(gen, cfg, device)
    return p


def _apply_mixer(p, x, cfg, kind, positions, *, causal, remat):
    if kind == RGLRU:
        return rec_mod.apply_rglru_block(p, x, cfg)
    if kind == MLSTM:
        return xlstm_mod.apply_mlstm_block(p, x, cfg)
    if kind == SLSTM:
        return xlstm_mod.apply_slstm_block(p, x, cfg)
    if kind not in (ATTN, LOCAL):
        raise ValueError(kind)

    def f(p_, x_):
        out, _ = attn_mod.attention(p_, x_, cfg, positions, kind=kind,
                                    causal=causal)
        return out

    if remat == "attn":
        return checkpoint(f, p, x, use_reentrant=False)
    return f(p, x)


def _cross(p, x, enc_states, cfg):
    """The pre-norm cross-attention residual of a decoder layer; x as it is
    for a layer without one."""
    if "cross" not in p:
        return x
    return x + attn_mod.cross_attention(p["cross"], apply_norm(p["norm_x"], x),
                                        enc_states, cfg)


def _ffn(p, x, cfg):
    """The layer's pre-norm FFN residual (the twin's ``_apply_ffn`` and the
    residual around it): (x, aux), aux the MoE's aux loss, 0 for a dense
    FFN or none."""
    if "ffn" not in p:
        return x, 0.0
    xn = apply_norm(p["norm2"], x)
    if cfg.moe is not None:
        h, aux = moe_mod.apply_moe(p["ffn"], xn, cfg)
    else:
        h, aux = apply_mlp(p["ffn"], xn, cfg), 0.0
    return x + h, aux


#: Mixer kinds that can run sequence slices (seq_chunks > 1): causal
#: attention over a retained-KV prefix. The recurrent kinds (RGLRU, xLSTM)
#: carry state across the sequence that a slice boundary would cut.
SLICEABLE_KINDS = (ATTN, LOCAL)


def apply_layer_sliced(p, x, cfg, kind, positions, kv_prefix, *,
                       remat="none"):
    """One layer over ONE sequence slice with a retained-KV prefix.

    Returns (x, aux_loss, (k, v)): the slice's own post-RoPE KV, which the
    pipeline executor keeps for later slices. Only attention mixers
    (``SLICEABLE_KINDS``) can slice; cross-attention layers cannot (the
    encoder states span the whole sequence). A MoE FFN routes the slice on
    its own: its capacity follows the slice's length, as in the twin.
    """
    if kind not in SLICEABLE_KINDS:
        raise ValueError(
            f"seq_chunks > 1 needs attention mixers, got {kind!r}")
    if "cross" in p:
        raise ValueError("seq_chunks > 1 does not support cross-attention")

    def mix(p_, x_, pk, pv):
        return attn_mod.attention_sliced(p_, x_, cfg, positions, (pk, pv),
                                         kind=kind)

    if remat == "attn":
        h, kv = checkpoint(mix, p["mixer"], apply_norm(p["norm1"], x),
                           *kv_prefix, use_reentrant=False)
    else:
        h, kv = mix(p["mixer"], apply_norm(p["norm1"], x), *kv_prefix)
    x, aux = _ffn(p, x + h, cfg)
    return x, aux, kv


def apply_layer(p, x, cfg, kind, positions, *, enc_states=None, causal=True,
                remat="none"):
    """Train/prefill layer. Returns (x, aux_loss); aux is 0 for a dense
    FFN."""
    x = x + _apply_mixer(p["mixer"], apply_norm(p["norm1"], x), cfg, kind,
                         positions, causal=causal, remat=remat)
    return _ffn(p, _cross(p, x, enc_states, cfg), cfg)


# ---- per-layer recurrent/KV state ----------------------------------------------
def init_layer_state(cfg, kind, batch, max_len, dtype, device):
    if kind in (ATTN, LOCAL):
        return attn_mod.init_kv_cache(cfg, kind, batch, max_len, dtype, device)
    if kind == RGLRU:
        return rec_mod.init_rglru_state(cfg, batch, dtype, device)
    if kind == MLSTM:
        return xlstm_mod.init_mlstm_state(cfg, batch, device)
    if kind == SLSTM:
        return xlstm_mod.init_slstm_state(cfg, batch, device)
    raise ValueError(kind)


def _rglru_prefill(p, xn, cfg, state):
    """The RG-LRU block that also writes its terminal state in place: h at
    the last position (fp32, after the rounding to the compute dtype the
    block's output takes) and the conv's last cw - 1 inputs, left-padded
    with zeros when the prompt is shorter."""
    u = cast_matmul(xn, p["in_x"])
    g = F.gelu(cast_matmul(xn, p["in_g"]), approximate="tanh")
    h = rec_mod.rglru_scan(p, rec_mod._conv_full(p, u))
    out = cast_matmul(h * g, p["out"])
    tail = u[:, -(cfg.conv_width - 1):]
    state["h"].copy_(h[:, -1].float())
    state["conv"].zero_()
    state["conv"][:, state["conv"].shape[1] - tail.shape[1]:] = tail
    return out, state


def _xlstm_prefill(p, xn, cfg, kind, state):
    """An xLSTM block that also writes its end state in place."""
    scan = xlstm_mod.mlstm_chunkwise if kind == MLSTM else xlstm_mod.slstm_scan
    h, end = scan(p, xn, cfg)
    for k, t in end.items():
        state[k].copy_(t)
    return attn_mod._merge_heads(h, p["wo"]), state


def apply_layer_prefill(p, x, cfg, kind, positions, state, *,
                        enc_states=None):
    """Like apply_layer but also fills this layer's decode state (in place)."""
    xn = apply_norm(p["norm1"], x)
    if kind in (ATTN, LOCAL):
        h, (k, v) = attn_mod.attention(p["mixer"], xn, cfg, positions,
                                       kind=kind)
        new_state = attn_mod.fill_kv_cache(state, k, v)
    elif kind == RGLRU:
        h, new_state = _rglru_prefill(p["mixer"], xn, cfg, state)
    elif kind in (MLSTM, SLSTM):
        h, new_state = _xlstm_prefill(p["mixer"], xn, cfg, kind, state)
    else:
        raise ValueError(kind)
    x, _ = _ffn(p, _cross(p, x + h, enc_states, cfg), cfg)
    return x, new_state


def apply_layer_decode(p, x, cfg, kind, pos, state, *, enc_states=None):
    """One-token decode. x: (b, 1, d). Returns (x, new_state)."""
    xn = apply_norm(p["norm1"], x)
    if kind in (ATTN, LOCAL):
        h, state = attn_mod.attention_decode(p["mixer"], xn, cfg, state, pos,
                                             kind=kind)
    elif kind == RGLRU:
        h, state = rec_mod.apply_rglru_block_step(p["mixer"], xn, cfg, state)
    elif kind == MLSTM:
        h, state = xlstm_mod.apply_mlstm_block_step(p["mixer"], xn, cfg, state)
    elif kind == SLSTM:
        h, state = xlstm_mod.apply_slstm_block_step(p["mixer"], xn, cfg, state)
    else:
        raise ValueError(kind)
    x, _ = _ffn(p, _cross(p, x + h, enc_states, cfg), cfg)
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
    """How ``num_layers`` (default cfg.num_layers) decompose into stacked
    ``pattern`` (default cfg.block_pattern) blocks + remainder layers, and
    the loops that run them. ``cross=True`` gives each layer a cross
    attention (an encoder-decoder's decoder)."""

    def __init__(self, cfg, *, cross=False, num_layers=None, pattern=None):
        self.cfg = cfg
        self.cross = cross
        self.pattern = tuple(pattern or cfg.block_pattern)
        n = num_layers if num_layers is not None else cfg.num_layers
        self.num_layers = n
        self.n_full = n // len(self.pattern)
        self.rem = self.pattern[: n % len(self.pattern)]

    # -- init ---------------------------------------------------------------
    def init(self, gen, device):
        p = {}
        for j, kind in enumerate(self.pattern):
            if self.n_full:
                p[f"pos{j}"] = _stack_init(
                    self.n_full, lambda: init_layer(gen, self.cfg, kind, device,
                                                    cross=self.cross))
        for i, kind in enumerate(self.rem):
            p[f"rem{i}"] = init_layer(gen, self.cfg, kind, device,
                                      cross=self.cross)
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
    def apply(self, params, x, positions, *, enc_states=None, causal=True,
              remat="none"):
        cfg, pattern = self.cfg, self.pattern

        def block(x, block_params, enc_states):
            aux = 0.0
            for j, kind in enumerate(pattern):
                x, a = apply_layer(block_params[f"pos{j}"], x, cfg, kind,
                                   positions, enc_states=enc_states,
                                   causal=causal, remat=remat)
                aux = aux + a
            return x, aux

        aux = 0.0
        for block_params in self._blocks(params):
            if remat == "full":
                x, a = checkpoint(block, x, block_params, enc_states,
                                  use_reentrant=False)
            else:
                x, a = block(x, block_params, enc_states)
            aux = aux + a
        for i, kind in enumerate(self.rem):
            x, a = apply_layer(params[f"rem{i}"], x, cfg, kind, positions,
                               enc_states=enc_states, causal=causal,
                               remat=remat)
            aux = aux + a
        return x, aux

    # -- prefill (forward + fill decode state) ----------------------------------
    def prefill(self, params, x, positions, state, *, enc_states=None):
        """Returns (x, state); the state's tensors are filled in place."""
        for kind, p, st in self._layers(params, state):
            x, _ = apply_layer_prefill(p, x, self.cfg, kind, positions, st,
                                       enc_states=enc_states)
        return x, state

    # -- one-token decode --------------------------------------------------------
    def decode(self, params, x, pos, state, *, enc_states=None):
        """Returns (x, state); the state's tensors are updated in place."""
        for kind, p, st in self._layers(params, state):
            x, _ = apply_layer_decode(p, x, self.cfg, kind, pos, st,
                                      enc_states=enc_states)
        return x, state
