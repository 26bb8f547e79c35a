"""SPMD pipeline parallelism over ``torch.distributed`` ranks: the twin of
the JAX package's ``repro/pipeline/spmd.py`` (``shard_map`` +
collective_permute).

Every rank of a ("data", "model") mesh runs the same program on its own
shard (``make_spmd_train_loss``):

  * stages live on the mesh's "model" dim, one stage a rank; activations
    flow stage -> stage + 1 through ``collectives.ppermute`` (one
    ``batch_isend_irecv`` a hop);
  * microbatches stream GPipe-style over m + p - 1 ticks of a Python loop
    (the JAX twin's ``lax.scan``);
  * per-tick stage compute is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), so a rank keeps only the
    tick-boundary states;
  * ``bpipe_stash=True`` applies the BPipe eviction pattern to the saved
    tick-boundary state (``_remote_remat``): it is shipped to the paired
    stage after the forward tick and fetched back in the backward, two more
    hops a tick, counted by ``collectives.read()``.

Hops a rank runs in one loss-and-grad step, m microbatches over p stages,
T = m + p - 1 ticks: T shifts forward and T - 1 backward (the last tick's
shift has no reader, so no backward), plus one EVICT and one LOAD a tick
under ``bpipe_stash``: 2T - 1, or 4T - 1. Each carries mb x s x d
activations of the compute dtype.

Where the port differs in form from the twin, and why:

  * The twin keeps the received state in stage 0's graph with
    ``jnp.where(idx == 0, inj, state)`` and runs the vocab matmul on every
    stage times an indicator (a ``lax.cond`` deadlocks there). A rank's
    backward must run every hop's backward that its partner runs, in the
    same order, or the partner waits forever. So here each tensor a rank
    receives or sends but does not feed to its loss is tied to the loss
    with weight zero (``_zero_tie``): stage 0's received state, and each
    tick's output on a rank or tick that computes no loss. Only then is the
    vocab matmul gated: the last stage runs it on the m ticks that carry a
    microbatch (the twin: every stage, every tick), and only stage 0 embeds
    (the twin: every stage). The loss and grads are the twin's: the terms
    left out are exact zeros there.
  * Grads: ``shard_map``'s transpose of the in_specs sums the cotangent of
    a ``P()`` param (embed, final_norm) over every rank, and of a
    ``P("model")`` param (the stage) over the data ranks; here the same
    sums are explicit all-reduces after the backward. With the loss
    ``pmean``ed over data, they are the mean over the data replicas.

Uniform stages required: num_layers % p == 0 (true for the paper's
GPT-3/LLaMA at p = 16, the Fig. 2 configuration).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import apply_layer, init_layer
from repro_torch.models.layers import (apply_norm, cdtype, embed, init_embed,
                                       init_norm, unembed)
from repro_torch.pipeline import collectives as C


# ---------------------------------------------------------------------------
# Parameters: one stage a rank
# ---------------------------------------------------------------------------
def _stage_seed(seed: int, stage: int) -> int:
    """The seed of stage ``stage``'s layers, drawn from the shared ``seed``."""
    return seed * 1_000_003 + 1 + stage


def init_pipeline_params(gen: torch.Generator, cfg: ModelConfig, p: int,
                         stage: int, device):
    """Rank ``stage``'s params: its ``num_layers // p`` layers
    (``{"stages": {j: layer}}``), drawn from a generator seeded by
    ``_stage_seed(gen.initial_seed(), stage)``, and the replicated
    ``embed`` and ``final_norm``, drawn from ``gen`` itself (every rank
    passes a generator of the same seed, so they are equal)."""
    assert cfg.num_layers % p == 0, (cfg.num_layers, p)
    per = cfg.num_layers // p
    kinds = cfg.layer_kinds()
    assert all(k == kinds[0] for k in kinds) or per % len(cfg.block_pattern) == 0, \
        "stage boundaries must align with the block pattern"
    shared = init_embed(gen, cfg, device)
    g = torch.Generator(device=gen.device).manual_seed(
        _stage_seed(gen.initial_seed(), stage))
    return {
        "stages": {j: init_layer(g, cfg, kinds[j], device) for j in range(per)},
        "embed": shared,
        "final_norm": init_norm(cfg, device=device),
    }


def from_jax_pipeline_params(tree, stage: int, device):
    """Rank ``stage``'s params from the JAX twin's ``init_pipeline_params``
    brought to the host as numpy arrays (``stages`` a list of per-layer
    trees whose leaves lead with the stage dim p)."""
    def take(layer):
        return {k: take(v) if isinstance(v, dict) else v[stage]
                for k, v in layer.items()}
    return {"stages": {j: bridge.to_torch(take(layer), device)
                       for j, layer in enumerate(tree["stages"])},
            "embed": bridge.to_torch(tree["embed"], device),
            "final_norm": bridge.to_torch(tree["final_norm"], device)}


# ---------------------------------------------------------------------------
# BPipe remote stash (an autograd Function around the per-tick stage compute)
# ---------------------------------------------------------------------------
class _RemoteRemat(torch.autograd.Function):
    """fwd: y = fn(params, x) without saving its activations; EVICT x to
    the partner and keep the partner's x. bwd: LOAD x back from the
    partner, recompute fn under grad, take grads w.r.t. x and params."""

    @staticmethod
    def forward(ctx, fn, paths, perm_out, perm_back, group, x, *leaves):
        y = fn(T.unflatten(paths, leaves), x)
        stash = C.ppermute_raw(x, perm_out, group)                 # EVICT
        ctx.fn, ctx.paths, ctx.perm_back, ctx.group = fn, paths, perm_back, group
        ctx.save_for_backward(stash, *leaves)
        return y

    @staticmethod
    def backward(ctx, g):
        stash, *leaves = ctx.saved_tensors
        x = C.ppermute_raw(stash, ctx.perm_back, ctx.group)       # LOAD
        x = x.detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for t in leaves]
        with torch.enable_grad():
            y = ctx.fn(T.unflatten(ctx.paths, leaves), x)
        grads = torch.autograd.grad(y, [x] + leaves, g, allow_unused=True)
        return (None, None, None, None, None) + tuple(grads)


def _remote_remat(fn, perm_out, perm_back, group):
    """Recompute-in-backward whose saved input lives on the BPipe partner.

    fwd: y = fn(params, x); residual = ppermute(x -> partner)
    bwd: x = ppermute(residual -> back); grads = vjp(fn)(g)
    """
    def wrapped(params, x):
        paths = [path for path, _ in T.leaves_with_paths(params)]
        return _RemoteRemat.apply(fn, paths, perm_out, perm_back, group, x,
                                  *T.leaves(params))
    return wrapped


def _bpipe_perms(p: int):
    """Device-level permutation pairs for the eviction hop. With the
    pair-adjacent layout stages sit so each (x, p-1-x) pair is 1 ICI hop
    apart; on the raw stage axis the permutation is stage->partner."""
    pairs = [(x, p - 1 - x) for x in range(p // 2)]
    perm_out = [(a, b) for a, b in pairs] + [(b, a) for a, b in pairs]
    if p % 2:
        mid = p // 2
        perm_out.append((mid, mid))
    return perm_out, perm_out  # involution: same permutation both ways


class _ZeroTie(torch.autograd.Function):
    """A 0 that depends on its inputs: its backward hands each a zero
    cotangent, so the hops that made or consume them run their backward on
    this rank as on their partner."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.specs = [(x.shape, x.dtype, x.device) for x in xs]
        return torch.zeros((), dtype=torch.float32, device=xs[0].device)

    @staticmethod
    def backward(ctx, g):
        return tuple(torch.zeros(s, dtype=d, device=dev) for s, d, dev in ctx.specs)


def _zero_tie(*xs):
    return _ZeroTie.apply(*xs)


# ---------------------------------------------------------------------------
# The pipelined loss
# ---------------------------------------------------------------------------
def pipeline_loss_fn(cfg: ModelConfig, mesh, p: int, num_micro: int, *,
                     stage_axis: str = "model", data_group=None,
                     bpipe_stash: bool = False, remat: bool = True):
    """Returns loss(params, batch) for this rank of ``mesh``.

    params: this rank's stage (``init_pipeline_params``); batch:
    tokens/labels (local_batch, s), this rank's data shard. ``data_group``
    is the group the loss is averaged over (None: no data axis).
    """
    per = cfg.num_layers // p
    kinds = cfg.layer_kinds()
    idx = mesh.get_local_rank(stage_axis)
    stage_group = mesh.get_group(stage_axis)
    assert dist.get_world_size(stage_group) == p, (p, mesh)

    def stage_compute(stage_params, x):
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device)[None].expand(b, s)
        for j in range(per):
            x, _ = apply_layer(stage_params[j], x, cfg, kinds[j], positions)
        return x

    perm_out, perm_back = _bpipe_perms(p)
    if bpipe_stash:
        stage_fn = _remote_remat(stage_compute, perm_out, perm_back, stage_group)
    elif remat:
        def stage_fn(stage_params, x):
            return checkpoint(stage_compute, stage_params, x, use_reentrant=False)
    else:
        stage_fn = stage_compute

    shift = [(i, (i + 1) % p) for i in range(p)]

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        bsz, s = tokens.shape
        assert bsz % num_micro == 0, (bsz, num_micro)
        mb = bsz // num_micro
        tok_mb = tokens.reshape(num_micro, mb, s)
        lbl_mb = labels.reshape(num_micro, mb, s)

        state = torch.zeros((mb, s, cfg.d_model), dtype=cdtype(cfg),
                            device=tokens.device)
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for t in range(num_micro + p - 1):
            if idx == 0:
                # stage 0 injects the next microbatch's embeddings (zeros
                # past the last, as the twin's padding)
                tok_t = tok_mb[t] if t < num_micro else torch.zeros_like(tok_mb[0])
                if t:  # the received state stays in the graph
                    total = total + _zero_tie(state)
                x = embed(params["embed"], tok_t, cfg)
            else:
                x = state
            y = stage_fn(params["stages"], x)

            # Microbatch loss on the last stage, on the ticks that carry one
            micro = t - (p - 1)
            if idx == p - 1 and micro >= 0:
                xl = apply_norm(params["final_norm"], y)
                logits = unembed(params["embed"], xl, cfg)
                lbl_t = lbl_mb[micro]
                mask = (lbl_t >= 0).float()
                lbl = lbl_t.clamp_min(0).long()
                logp = torch.log_softmax(logits.float(), -1)
                nll = -torch.gather(logp, -1, lbl[..., None])[..., 0]
                total = total + (nll * mask).sum() / mask.sum().clamp_min(1.0)
            else:
                total = total + _zero_tie(y)
            state = C.ppermute(y, shift, stage_group)

        total = total / num_micro
        total = C.psum(total, stage_group)
        if data_group is not None:
            total = C.pmean(total, data_group)
        return total

    return loss_fn


def _data_group(mesh, data_axes):
    """The group of the ranks that share this rank's stage: the data dims
    flattened into one (the mesh keeps the flattened dim, so a second call
    reuses its group)."""
    if not data_axes:
        return None
    if len(data_axes) == 1:
        return mesh.get_group(data_axes[0])
    return mesh[data_axes]._flatten().get_group()


def make_spmd_train_loss(cfg: ModelConfig, mesh, p: int, num_micro: int,
                         *, bpipe_stash: bool = False):
    """The pipeline loss on this rank of the production mesh: the "model"
    dim carries stages, the remaining dims carry data. Returns
    ``loss_and_grads(params, batch) -> (loss, grads)``; the grads have
    ``params``' nesting and are summed as the twin's ``shard_map``
    transposes its in_specs: ``embed`` and ``final_norm`` over every rank,
    the stage's layers over the data ranks."""
    assert mesh.size() == dist.get_world_size(), \
        "every rank of the world runs one shard of the mesh"
    data_axes = tuple(a for a in mesh.mesh_dim_names if a != "model")
    data_group = _data_group(mesh, data_axes)
    inner = pipeline_loss_fn(cfg, mesh, p, num_micro, stage_axis="model",
                             data_group=data_group, bpipe_stash=bpipe_stash)
    everyone = dist.group.WORLD

    def loss_and_grads(params: Dict[str, Any], batch):
        paths = [path for path, _ in T.leaves_with_paths(params)]
        leaves = [t.detach().requires_grad_(True) for t in T.leaves(params)]
        loss = inner(T.unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for path, leaf, g in zip(paths, leaves, grads):
            g = torch.zeros_like(leaf) if g is None else g
            if path[0] == "stages":
                if data_group is not None:
                    C.all_reduce_(g, data_group)
            else:
                C.all_reduce_(g, everyone)
            out.append(g)
        return loss.detach(), T.unflatten(paths, out)

    return loss_and_grads
