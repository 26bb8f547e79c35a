"""train_step / prefill_step / serve_step factories (the twin of the JAX
package's ``repro/train/steps.py``).

A train step takes the grads with ``torch.autograd.grad`` over the param
leaves (no ``.grad`` fields), so it reads like the twin's
``jax.value_and_grad``; ``adam.update`` then writes the new params and
moments into the given tensors, which a second copy of the state would
not fit beside at full width.

With a mesh, ``make_train_step`` returns ``(step, shardings)`` as the twin
does: ``shardings`` gives the placements of ``sharding/rules.py`` for the
params, the Adam state and the batch (computed once a tree), and the step
takes DTensors with those placements (``rules.distribute``), as does
``make_loss_grad`` with a mesh. Tensors the model makes inside (positions,
RoPE tables, masks, scalars) are plain: the step runs under
``implicit_replication`` so they take part as replicated, and it checks
every param, moment and batch leaf on entry, so a leaf of the wrong
placement raises instead. Each grad is redistributed to its param's
placements before Adam: a replicated leaf's grad comes back ``Partial``
over the data axes and is summed there, the all-reduce the twin's
partitioner inserts.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.sharding import rules


def _loss_and_grads(params, batch, cfg: ModelConfig, remat: str, mesh=None):
    """(total loss, metrics, grads) of ``M.loss_fn``; grads in the params'
    nesting, detached, and with a mesh each redistributed to its param's
    placements."""
    paths, leaves = zip(*T.leaves_with_paths(params))
    req = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(T.unflatten(paths, req), batch, cfg,
                                  remat=remat)
        grads = torch.autograd.grad(loss, req, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(req, grads)]
    if mesh is not None:
        grads = [g.redistribute(mesh, t.placements) for t, g in zip(req, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            T.unflatten(paths, grads))


def _shardings_of(mesh):
    """``shardings(params, opt_state, batch)`` of ``mesh``: the placements
    of the params, the Adam state and the batch, computed once for each
    tree of names and shapes."""
    from torch.distributed.tensor import Replicate
    cache = {}

    def key(tree):
        return tuple((p, tuple(t.shape)) for p, t in T.leaves_with_paths(tree))

    def shardings(params, opt_state, batch):
        k = (key(params), key(batch))
        if k not in cache:
            ps = rules.param_shardings(params, mesh)
            cache[k] = (ps, adam.AdamState(step=(Replicate(),) * mesh.ndim,
                                           m=ps, v=ps),
                        rules.batch_shardings(batch, mesh))
        return cache[k]

    return shardings


def _on_mesh(mesh, shardings, fn):
    """``fn(params, *rest, batch)`` on DTensors of ``mesh``: every param,
    moment and batch leaf is checked against ``shardings`` first (a leaf of
    the wrong placements raises), then ``fn`` runs under ``set_mesh`` and
    ``implicit_replication``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def check(tree, want, what):
        for path, leaf in T.leaves_with_paths(tree):
            node = want
            for k in path:
                node = node[k]
            if not isinstance(leaf, DTensor) or leaf.device_mesh != mesh:
                raise TypeError(f"{what}/{'/'.join(path)} is not a DTensor of "
                                f"the step's mesh: {type(leaf).__name__}")
            if tuple(leaf.placements) != tuple(node):
                raise ValueError(f"{what}/{'/'.join(path)} has placements "
                                 f"{tuple(leaf.placements)}, the rules give "
                                 f"{tuple(node)}")

    def run(params, *rest):
        *opt_state, batch = rest
        ps, os_, bs = shardings(params, None, batch)
        check(params, ps, "params")
        for st in opt_state:
            check(st.m, ps, "opt_state.m")
            check(st.v, ps, "opt_state.v")
            check({"step": st.step}, {"step": os_.step}, "opt_state")
        check(batch, bs, "batch")
        with rules.set_mesh(mesh), implicit_replication():
            return fn(params, *rest)

    return run


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics); with a
    ``mesh``, ``(step, shardings)``."""

    def step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(params, batch, cfg, tcfg.remat,
                                               mesh)
        params, opt_state, opt_metrics = adam.update(
            params, grads, opt_state, tcfg)
        return params, opt_state, dict(metrics, **opt_metrics, total=loss)

    if mesh is None:
        return step
    shardings = _shardings_of(mesh)
    return _on_mesh(mesh, shardings, step), shardings


def make_loss_grad(cfg: ModelConfig, tcfg: TrainConfig, mesh=None):
    """Bare loss+grad (no optimizer): (params, batch) -> (loss, grads); with
    a ``mesh``, on DTensors as ``make_train_step``'s step takes them, the
    grads in their params' placements."""

    def f(params, batch):
        loss, _, grads = _loss_and_grads(params, batch, cfg, tcfg.remat, mesh)
        return loss, grads

    return f if mesh is None else _on_mesh(mesh, _shardings_of(mesh), f)


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
