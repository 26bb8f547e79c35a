"""Top-level model: embeddings -> PatternStack -> norm -> logits.

Covers every family of the JAX twin:
  * decoder-only LMs (dense / MoE / RG-LRU hybrid / xLSTM),
  * encoder-decoder (whisper: stub audio-frame embeddings -> encoder,
    tokens -> decoder with cross attention),
  * VLM (stub vision patch embeddings prepended to the token stream).

API:
  init_params(gen, cfg, device="cuda")
  forward(params, batch, cfg, remat=...) -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat=...) -> (loss, metrics)
  init_decode_state(cfg, batch, max_len, device="cuda")
  prefill(params, batch, cfg, state) -> (logits_last, state, enc_states)
  decode_step(params, token, pos, state, cfg, enc_states=None)
      -> (logits, state)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.blocks import PatternStack
from repro_torch.models.layers import (apply_norm, cdtype, embed,
                                       gather_dims, init_embed, init_norm,
                                       unembed)
from repro_torch.obs.ranges import span

ENCODER_FRAMES = 1500  # whisper-style fixed encoder length (core/flops.py)


def _stacks(cfg: ModelConfig):
    """(decoder stack, encoder stack or None)."""
    dec = PatternStack(cfg, cross=cfg.is_encdec)
    enc = None
    if cfg.is_encdec:
        enc = PatternStack(cfg, num_layers=cfg.encoder_layers, pattern=(ATTN,))
    return dec, enc


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random params (fp32) on ``device``, drawn from ``gen`` (which must
    live on the same device type). ``cuda`` without a card raises; pass
    ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    dec, enc = _stacks(cfg)
    p: Dict[str, Any] = {
        "embed": init_embed(gen, cfg, device),
        "blocks": dec.init(gen, device),
        "final_norm": init_norm(cfg, device=device),
    }
    if enc is not None:
        p["encoder"] = {"blocks": enc.init(gen, device),
                        "norm": init_norm(cfg, device=device)}
    return p


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


def encode(params, enc_embeds, cfg):
    """Stub-frontend encoder: enc_embeds (b, frames, d) are precomputed
    frame embeddings. Bidirectional attention (``_sdpa``) with RoPE. A
    profiler sees its forward as the range "encoder"."""
    _, enc = _stacks(cfg)
    with span("encoder"):
        x = enc_embeds.to(cdtype(cfg))
        x, _ = enc.apply(params["encoder"]["blocks"], x,
                         _positions(*x.shape[:2], x.device), causal=False)
        return apply_norm(params["encoder"]["norm"], x)


def _embed_inputs(params, batch, cfg):
    """Token (+ a VLM's prefix) embedding. Returns (x, positions,
    n_prefix)."""
    x = embed(params["embed"], batch["tokens"], cfg)
    n_prefix = 0
    if cfg.frontend == "vision" and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(x.dtype)
        n_prefix = pre.shape[1]
        x = torch.cat([pre, x], dim=1)
    return x, _positions(*x.shape[:2], x.device), n_prefix


def _enc_states(params, batch, cfg):
    return encode(params, batch["enc_embeds"], cfg) if cfg.is_encdec else None


def forward(params, batch, cfg: ModelConfig, *, remat="none"):
    """batch: {tokens (b, s) [, prefix_embeds (b, n, d), enc_embeds (b,
    frames, d)]}. Returns (logits over the token positions, the MoE aux
    loss summed over the layers; 0 without MoE)."""
    dec, _ = _stacks(cfg)
    enc_states = _enc_states(params, batch, cfg)
    x, positions, n_prefix = _embed_inputs(params, batch, cfg)
    x, aux = dec.apply(params["blocks"], x, positions, enc_states=enc_states,
                       remat=remat)
    x = apply_norm(params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    return unembed(params["embed"], x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, *, remat="none"):
    """Next-token cross-entropy in fp32 + the MoE aux (0 without MoE).
    labels == -1 is masked. Returns (total, {"loss", "aux"}).

    Two implementations, as in the JAX twin: the default takes
    ``log_softmax`` and gathers the label's entry; ``cfg.fused_xent``
    takes logsumexp minus a masked pick of the label's logit. On DTensor
    logits both are the vocab-parallel ``_nll_vocab_parallel``.
    """
    from torch.distributed.tensor import DTensor
    logits, aux = forward(params, batch, cfg, remat=remat)
    # labels sharded past their batch dim (a batch the data axes do not
    # divide, relocated by the rules) are gathered, as the embedding
    # gathers the tokens: each rank then takes the loss of whole rows
    labels = gather_dims(batch["labels"], (1,), tag="labels")
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0).long()
    lf = logits.float()
    if isinstance(lf, DTensor):
        nll = _nll_vocab_parallel(lf, labels)
    elif cfg.fused_xent:
        lse = torch.logsumexp(lf, dim=-1)
        vocab = torch.arange(lf.shape[-1], device=lf.device)
        picked = torch.where(vocab == labels[..., None], lf, 0.0).sum(-1)
        nll = lse - picked
    else:
        logp = torch.log_softmax(lf, dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux, {"loss": loss, "aux": aux}


def _nll_vocab_parallel(lf, labels):
    """-log softmax(lf)[label] of DTensor logits lf (b, s, V) fp32 on each
    rank's local logits, where the vocab stays sharded as the rules place
    the table (a rank never holds the whole vocab): the logsumexp of each
    rank's vocab rows, all-gathered over the vocab-sharded mesh dims and
    combined, less the label's logit, which the rank holding it gives (the
    others 0, summed over those mesh dims). Both cross-entropy arms
    (``cfg.fused_xent`` or not) are this lse - picked. A partial sum of lf
    (a table whose vocab the mesh dim does not divide, relocated onto d) is
    summed into a vocab shard (a reduce-scatter, uneven where the dim does
    not divide it); labels take lf's placements at (b, s)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.sharding import rules
    mesh, vocab = lf.device_mesh, lf.shape[-1]
    lf = rules.redistribute(lf, [Shard(2) if p.is_partial() else p
                                 for p in lf.placements], "logits_partial")
    vdims = [i for i, p in enumerate(lf.placements) if p == Shard(2)]
    rows = [Replicate() if i in vdims else p
            for i, p in enumerate(lf.placements)]
    labels = rules.redistribute(labels, rows, "labels").to_local()
    lo, hi = rules.local_range(vocab, mesh, lf.placements, 2)
    x = lf.to_local()
    over = lambda t, pl: DTensor.from_local(t, mesh, [
        pl if i in vdims else p for i, p in enumerate(rows)],
        run_check=False).redistribute(mesh, rows).to_local()
    # the logsumexp of each rank's vocab rows, gathered in mesh order
    lse = torch.logsumexp(over(torch.logsumexp(x, -1)[..., None], Shard(2)), -1)
    inside = (labels >= lo) & (labels < hi)
    mine = x.gather(-1, (labels - lo).clamp(0, hi - lo - 1)[..., None])[..., 0]
    picked = over(torch.where(inside, mine, 0.0), Partial())
    return DTensor.from_local(lse - picked, mesh, rows, run_check=False)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda"):
    """Empty decode state on ``device``: a KV cache for each attention layer
    (a ring of the window for LOCAL), the recurrence h (fp32) and conv tail
    for each RG-LRU layer, the fp32 memories and stabilisers of each xLSTM
    layer. A VLM's max_len counts its prefix. ``cuda`` without a card
    raises."""
    dec, _ = _stacks(cfg)
    return dec.init_state(batch, max_len, cdtype(cfg), resolve_device(device))


def prefill(params, batch, cfg: ModelConfig, state):
    """Run the full prompt (after a VLM's prefix), fill the decode state and
    return (last-position logits, state, the encoder's states or None)."""
    dec, _ = _stacks(cfg)
    enc_states = _enc_states(params, batch, cfg)
    x, positions, _ = _embed_inputs(params, batch, cfg)
    x, state = dec.prefill(params["blocks"], x, positions, state,
                           enc_states=enc_states)
    x = apply_norm(params["final_norm"], x[:, -1:])
    return unembed(params["embed"], x, cfg)[:, 0], state, enc_states


def decode_step(params, token, pos, state, cfg: ModelConfig, enc_states=None):
    """token: (b,) int; pos: int (position being written, a VLM's prefix
    included); enc_states: ``prefill``'s, for an encoder-decoder."""
    x = embed(params["embed"], token[:, None], cfg)
    dec, _ = _stacks(cfg)
    x, state = dec.decode(params["blocks"], x, pos, state,
                          enc_states=enc_states)
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg)[:, 0], state
