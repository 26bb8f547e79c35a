"""prefill_step / serve_step factories (the serving half of the JAX twin;
the training steps are not ported yet)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, state) -> (logits_last, state)."""

    def step(params, batch, state):
        return M.prefill(params, batch, cfg, state)

    return step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, state, token, pos)
    -> (next_token, logits, state)."""

    def step(params, state, token, pos):
        logits, state = M.decode_step(params, token, pos, state, cfg)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, state

    return step
