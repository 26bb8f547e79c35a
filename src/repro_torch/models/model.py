"""Top-level model: embeddings -> PatternStack -> norm -> logits.

Covers the decoder-only LMs with attention mixers and dense FFNs; the
encoder-decoder (whisper) and vision-prefix (VLM) inputs raise.

API:
  init_params(gen, cfg, device="cuda")
  forward(params, batch, cfg, remat=...) -> (logits, aux_loss)
  loss_fn(params, batch, cfg, remat=...) -> (loss, metrics)
  init_decode_state(cfg, batch, max_len, device="cuda")
  prefill(params, batch, cfg, state) -> (logits_last, state)
  decode_step(params, token, pos, state, cfg) -> (logits, state)
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import PatternStack
from repro_torch.models.layers import (apply_norm, cdtype, embed, init_embed,
                                       init_norm, unembed)

ENCODER_FRAMES = 1500  # whisper-style fixed encoder length (core/flops.py)


def _stack(cfg: ModelConfig) -> PatternStack:
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP queue A, "
            "enc-dec paths)")
    return PatternStack(cfg)


def init_params(gen: torch.Generator, cfg: ModelConfig, device="cuda"):
    """Random params (fp32) on ``device``, drawn from ``gen`` (which must
    live on the same device type). ``cuda`` without a card raises; pass
    ``device="cpu"`` for the CPU."""
    device = resolve_device(device)
    dec = _stack(cfg)
    p: Dict[str, Any] = {
        "embed": init_embed(gen, cfg, device),
        "blocks": dec.init(gen, device),
        "final_norm": init_norm(cfg, device=device),
    }
    return p


def _embed_inputs(params, batch, cfg):
    """Token embedding. Returns (x, positions)."""
    if "prefix_embeds" in batch or "enc_embeds" in batch:
        raise NotImplementedError(
            "vision-prefix and encoder inputs are not ported yet (ROADMAP "
            "queue A, enc-dec paths)")
    x = embed(params["embed"], batch["tokens"], cfg)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    return x, positions[None].expand(b, s)


def forward(params, batch, cfg: ModelConfig, *, remat="none"):
    """batch: {tokens (b, s)}. Returns (logits over token positions, aux)."""
    x, positions = _embed_inputs(params, batch, cfg)
    x, aux = _stack(cfg).apply(params["blocks"], x, positions, remat=remat)
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, *, remat="none"):
    """Next-token cross-entropy in fp32 + aux (0 for a dense FFN).
    labels == -1 is masked. Returns (total, {"loss", "aux"}).

    Two implementations, as in the JAX twin: the default takes
    ``log_softmax`` and gathers the label's entry; ``cfg.fused_xent``
    takes logsumexp minus a masked pick of the label's logit.
    """
    logits, aux = forward(params, batch, cfg, remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    labels = labels.clamp_min(0).long()
    lf = logits.float()
    if cfg.fused_xent:
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


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      device="cuda"):
    """Empty KV caches on ``device``; ``cuda`` without a card raises."""
    return _stack(cfg).init_state(batch, max_len, cdtype(cfg),
                                  resolve_device(device))


def prefill(params, batch, cfg: ModelConfig, state):
    """Run the full prompt, fill decode state, return last-position logits."""
    x, positions = _embed_inputs(params, batch, cfg)
    x, state = _stack(cfg).prefill(params["blocks"], x, positions, state)
    x = apply_norm(params["final_norm"], x[:, -1:])
    return unembed(params["embed"], x, cfg)[:, 0], state


def decode_step(params, token, pos, state, cfg: ModelConfig):
    """token: (b,) int; pos: int (position being written)."""
    x = embed(params["embed"], token[:, None], cfg)
    x, state = _stack(cfg).decode(params["blocks"], x, pos, state)
    x = apply_norm(params["final_norm"], x)
    return unembed(params["embed"], x, cfg)[:, 0], state
