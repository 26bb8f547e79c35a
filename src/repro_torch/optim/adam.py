"""Adam with weight decay, global-norm clipping, warmup+cosine schedule.

The twin of the JAX package's ``repro/optim/adam.py``, in the same order
of operations: master params and both moments in fp32, the grads clipped
by their global norm (+1e-9), b2 = 0.95, bias correction from the
incremented step and the learning rate from the step before it, weight
decay only on leaves with ndim >= 2, added to the update before the lr.

``update`` writes the new params and moments into the given tensors: a
second copy of params and moments would not fit one card at full width.
``AdamState``'s fields (``step``, ``m``, ``v``) give the checkpoint keys
``opt/step``, ``opt/m/...`` and ``opt/v/...`` of the twin.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass
class AdamState:
    step: torch.Tensor  # int32, 0-dim, on the params' device
    m: Any
    v: Any


def init(params) -> AdamState:
    """Zero moments in fp32 and step 0. On DTensor params (the sharded
    step) the moments are DTensors of the params' placements, each rank
    holding its shard only, and the step a replicated DTensor."""
    zeros = lambda t: T.tree_map(
        lambda a: torch.zeros_like(a, dtype=torch.float32), t)
    first = T.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(first, DTensor):
        step = DTensor.from_local(step, first.device_mesh,
                                  [Replicate()] * first.device_mesh.ndim,
                                  run_check=False)
    return AdamState(step=step, m=zeros(params), v=zeros(params))


def lr_schedule(tcfg: TrainConfig, step):
    """The learning rate at ``step`` (an int tensor), as an fp32 tensor."""
    warm = torch.clamp((step + 1) / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                          for a in T.leaves(tree)))


def update(params, grads, state: AdamState, tcfg: TrainConfig,
           b1=0.9, b2=0.95, eps=1e-8):
    """Returns (params, new_state, metrics); params and the moments are
    updated in place, the grads are left as they are."""
    step = state.step + 1
    gn = global_norm(grads)
    clip = (torch.clamp(tcfg.grad_clip / (gn + 1e-9), max=1.0)
            if tcfg.grad_clip else 1.0)
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    lr = lr_schedule(tcfg, state.step)
    for p, g, mu, nu in zip(T.leaves(params), T.leaves(grads),
                            T.leaves(state.m), T.leaves(state.v)):
        g = g.float() * clip
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        d = (mu / bc1).div_((nu / bc2).sqrt_().add_(eps))
        if tcfg.weight_decay and p.dim() >= 2:  # no decay on norms/biases
            d.add_(p.float(), alpha=tcfg.weight_decay)
        d.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(d)
        else:
            p.copy_(p.float() - d)
    return params, AdamState(step=step, m=state.m, v=state.v), {
        "grad_norm": gn, "lr": lr}
