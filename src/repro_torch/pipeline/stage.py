"""Split a full model into pipeline stages (Megatron-style layer ranges):
the twin of the JAX package's ``repro/pipeline/stage.py``.

``StageSplitter.split`` hands each stage its layers' params as leaf tensors
of their own that share storage with the stacked params (the rows of
``blocks._rows``, detached, no copy), so autograd differentiates each stage
apart; ``merge`` restacks the per-stage grads into the params' structure so
the optimizer is pipeline-agnostic. Tied embeddings are replicated onto the
first and last stage, each a leaf of its own, and their grads summed at
merge (Megatron ties them with an all-reduce the same way).

A stage's layers are a dict keyed by the local layer index (0, 1, ...), so
the port's tree helpers flatten and rebuild stage params and grads.

As in the JAX twin, the first stage embeds the batch's tokens only: a VLM
pipelines text-only (its ``prefix_embeds`` are not read), and an
encoder-decoder has no pipelined path (the twin's stages carry no encoder
params and pass no encoder states), so its stage functions raise.

All functions are written over *virtual* stages: for interleaved schedules
with v chunks per device, pass ``p * v`` as the stage count and index with
``virtual_stage = chunk * p + device``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import (PatternStack, _rows, apply_layer,
                                      apply_layer_sliced)
from repro_torch.models.layers import apply_norm, embed, unembed


def layer_assignment(cfg: ModelConfig, p: int) -> List[List[int]]:
    """Contiguous layer ranges per stage (uniform; remainder to late stages,
    which hold fewer in-flight activations under 1F1B)."""
    n = cfg.num_layers
    base, extra = divmod(n, p)
    sizes = [base + (1 if i >= p - extra else 0) for i in range(p)]
    out, ℓ = [], 0
    for s in sizes:
        out.append(list(range(ℓ, ℓ + s)))
        ℓ += s
    return out


def _leaf(tree):
    """The same nesting of leaf tensors that share storage with ``tree``'s."""
    return T.tree_map(lambda t: t.detach().requires_grad_(True), tree)


class StageSplitter:
    """Per-(cfg, n_stages) split/merge with the layer assignment and
    PatternStack bookkeeping computed once."""

    def __init__(self, cfg: ModelConfig, n_stages: int):
        self.cfg, self.n = cfg, n_stages
        self.assign = layer_assignment(cfg, n_stages)
        self.stack = PatternStack(cfg)

    def _layer_params(self, params) -> Dict[int, Any]:
        """Every layer's params by layer index: views of the stacked rows
        (one ``torch.unbind`` per leaf), then the remainder layers."""
        k, n_full = len(self.stack.pattern), self.stack.n_full
        blocks = params["blocks"]
        rows = {j: _rows(blocks[f"pos{j}"], n_full)
                for j in range(k) if n_full}
        out = {}
        for ℓ in range(self.cfg.num_layers):
            blk, j = divmod(ℓ, k)
            out[ℓ] = rows[j][blk] if blk < n_full \
                else blocks[f"rem{ℓ - n_full * k}"]
        return out

    def split(self, params) -> List[Dict[str, Any]]:
        layer = self._layer_params(params)
        stages = []
        for i, layers in enumerate(self.assign):
            sp: Dict[str, Any] = {
                "layers": {local: _leaf(layer[ℓ])
                           for local, ℓ in enumerate(layers)}}
            if i == 0:
                sp["embed"] = _leaf(params["embed"])
            if i == self.n - 1:
                sp["final_norm"] = _leaf(params["final_norm"])
                # unembed weights (tied table or separate matrix)
                sp["unembed"] = _leaf(params["embed"])
            stages.append(sp)
        return stages

    def merge(self, stage_grads: List[Dict[str, Any]]):
        """Restack per-stage layer grads into full-model param structure."""
        k = len(self.stack.pattern)
        per_layer = {}
        for sg, layers in zip(stage_grads, self.assign):
            for local, ℓ in enumerate(layers):
                per_layer[ℓ] = sg["layers"][local]
        blocks: Dict[str, Any] = {}
        for j in range(k if self.stack.n_full else 0):
            rows = [per_layer[blk * k + j] for blk in range(self.stack.n_full)]
            blocks[f"pos{j}"] = T.tree_map(lambda *a: torch.stack(a), *rows)
        for i in range(len(self.stack.rem)):
            blocks[f"rem{i}"] = per_layer[self.stack.n_full * k + i]
        tail = stage_grads[-1]
        embed_grad = T.tree_map(torch.add, stage_grads[0]["embed"],
                                tail["unembed"])
        return {"embed": embed_grad, "blocks": blocks,
                "final_norm": tail["final_norm"]}


# ---------------------------------------------------------------------------
# Stage forward functions
# ---------------------------------------------------------------------------
def _check_decoder_only(cfg: ModelConfig):
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models have no pipelined path; the "
            "JAX twin's stages carry no encoder params or encoder states "
            "either")


def make_stage_fn(cfg: ModelConfig, p: int, stage: int, remat: str = "none"):
    """Returns f(stage_params, carry, batch) -> activation or loss.

    carry = (activation, running_aux); stage 0 ignores it and embeds the
    batch's tokens, the last stage returns the scalar mean loss of the
    microbatch (fp32 cross-entropy, labels < 0 masked) plus the aux.
    """
    _check_decoder_only(cfg)
    assign = layer_assignment(cfg, p)
    kinds = cfg.layer_kinds()
    layers = assign[stage]
    first, last = stage == 0, stage == p - 1

    def fn(sp, carry, batch):
        if first:
            x = embed(sp["embed"], batch["tokens"], cfg)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, aux = carry
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for local, ℓ in enumerate(layers):
            x, a = apply_layer(sp["layers"][local], x, cfg, kinds[ℓ],
                               positions, remat=remat)
            aux = aux + a
        if not last:
            return x, aux
        x = apply_norm(sp["final_norm"], x)
        logits = unembed(sp["unembed"], x, cfg)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        lbl = labels.clamp_min(0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss + aux

    return fn


def make_sliced_stage_fn(cfg: ModelConfig, p: int, stage: int,
                         remat: str = "none"):
    """The sequence-sliced stage forward (``ScheduleSpec.seq_chunks`` > 1).
    Returns

        f(sp, carry, kv_prefix, batch) -> (primary, kv_own)

    where ``batch`` holds this slice's tokens and labels plus ``"offset"``
    (the slice's global start position, an int), ``kv_prefix`` is one
    (k, v) pair per local layer covering global positions [0, offset)
    (zero-length for slice 0), and ``kv_own`` is the slice's own post-RoPE
    KV, one pair per local layer, which the executor keeps for later slices.

    ``primary`` is (activation, aux) on interior stages and (nll_sum, aux)
    on the last stage: the nll sum is NOT normalised; the executor divides
    it by the microbatch's count of valid tokens, so the slices' losses sum
    to the unsliced stage loss.
    """
    _check_decoder_only(cfg)
    assign = layer_assignment(cfg, p)
    kinds = cfg.layer_kinds()
    layers = assign[stage]
    first, last = stage == 0, stage == p - 1

    def fn(sp, carry, kv_prefix, batch):
        if first:
            x = embed(sp["embed"], batch["tokens"], cfg)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        else:
            x, aux = carry
        b, s = x.shape[:2]
        positions = (int(batch["offset"]) + torch.arange(
            s, dtype=torch.int32, device=x.device))[None].expand(b, s)
        kv_own = []
        for local, ℓ in enumerate(layers):
            x, a, kv = apply_layer_sliced(
                sp["layers"][local], x, cfg, kinds[ℓ], positions,
                kv_prefix[local], remat=remat)
            aux = aux + a
            kv_own.append(kv)
        kv_own = tuple(kv_own)
        if not last:
            return (x, aux), kv_own
        x = apply_norm(sp["final_norm"], x)
        logits = unembed(sp["unembed"], x, cfg)
        labels = batch["labels"]
        mask = (labels >= 0).float()
        lbl = labels.clamp_min(0).long()
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
        return ((nll * mask).sum(), aux), kv_own

    return fn
