"""train_step / prefill_step / serve_step factories (the twin of the JAX
package's ``repro/train/steps.py``, without its mesh shardings).

A train step takes the grads with ``torch.autograd.grad`` over the param
leaves (no ``.grad`` fields), so it reads like the twin's
``jax.value_and_grad``; ``adam.update`` then writes the new params and
moments into the given tensors, which a second copy of the state would
not fit beside at full width.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.optim import adam


def _loss_and_grads(params, batch, cfg: ModelConfig, remat: str):
    """(total loss, metrics, grads) of ``M.loss_fn``; grads in the params'
    nesting, detached."""
    paths, leaves = zip(*T.leaves_with_paths(params))
    req = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(T.unflatten(paths, req), batch, cfg,
                                  remat=remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(req, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(paths, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(params, batch, cfg, tcfg.remat)
        params, opt_state, opt_metrics = adam.update(
            params, grads, opt_state, tcfg)
        metrics = dict(metrics, **opt_metrics, total=loss)
        return params, opt_state, metrics

    return step


def make_loss_grad(cfg: ModelConfig, tcfg: TrainConfig):
    """Bare loss+grad (no optimizer): (params, batch) -> (loss, grads)."""

    def f(params, batch):
        loss, _, grads = _loss_and_grads(params, batch, cfg, tcfg.remat)
        return loss, grads

    return f


def make_prefill_step(cfg: ModelConfig):
    """(params, batch, state) -> (logits_last, state); an encoder-decoder's
    caller who needs the encoder's states calls ``model.prefill``."""

    def step(params, batch, state):
        logits, state, _ = M.prefill(params, batch, cfg, state)
        return logits, state

    return step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, state, token, pos[, enc_states])
    -> (next_token, logits, state)."""

    def step(params, state, token, pos, enc_states=None):
        logits, state = M.decode_step(params, token, pos, state, cfg,
                                      enc_states=enc_states)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, state

    return step


def init_all(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random params from ``seed`` and a fresh Adam state, on ``device``;
    ``cuda`` without a card raises."""
    device = resolve_device(device)
    params = M.init_params(torch.Generator(device).manual_seed(seed), cfg,
                           device)
    return params, adam.init(params)
