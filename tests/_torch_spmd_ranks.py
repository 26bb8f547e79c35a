"""Rank functions of the port's SPMD tests, in a module of their own: a
spawned rank imports the module of its function, and this one imports
torch and the port only (no JAX, no conftest), so each rank starts in
about a second."""
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.pipeline import collectives as C
from repro_torch.pipeline import spmd

B, S, M = 8, 16, 4


def small_cfg(layers):
    """Reduced qwen1.5-0.5b in fp32 at ``layers`` layers, as the JAX
    package's ``tests/test_spmd.py`` sets it up."""
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               num_layers=layers, dtype="float32")


def parity_rank(rank, world, data, model, layers, np_params, tokens):
    """Both arms' loss, grads (numpy, in ``T.leaves`` order) and the
    collective counter of one loss-and-grad step on this rank."""
    cfg = small_cfg(layers)
    mesh = make_host_mesh(data, model, "cpu")
    stage, d = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    params = spmd.from_jax_pipeline_params(np_params, stage, "cpu")
    toks = torch.from_numpy(tokens)
    lb = B // data
    shard = toks[d * lb:(d + 1) * lb]
    batch = {"tokens": shard[:, :-1], "labels": shard[:, 1:]}
    arms = {}
    for arm in ("1f1b", "bpipe"):
        step = spmd.make_spmd_train_loss(cfg, mesh, model, M,
                                         bpipe_stash=arm == "bpipe")
        C.reset()
        loss, grads = step(params, batch)
        arms[arm] = {"loss": float(loss), "counter": C.read(),
                     "grads": [g.numpy() for g in T.leaves(grads)]}
    return {"stage": stage, "data": d, "arms": arms}


def remat_rank(rank, world):
    """The JAX package's ``_remote_remat`` test on torch ranks: a stage
    function's grads (params replicated, x sharded over the ranks) with and
    without the remote stash, and the hops each ran."""
    group = dist.group.WORLD
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((8, 8), generator=gen) * 0.3,
              "b": torch.tensor(0.1)}
    x = torch.randn((world, 2, 8), generator=torch.Generator().manual_seed(1))[rank]

    def stage_fn(params, x):
        return torch.tanh(x @ params["w"]) + params["b"]

    perm_out, perm_back = spmd._bpipe_perms(world)
    out = {}
    for label, fn in (("plain", stage_fn),
                      ("remat", spmd._remote_remat(stage_fn, perm_out, perm_back,
                                                   group))):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xi = x.clone().requires_grad_(True)
        C.reset()
        y = fn(p, xi)
        loss = C.psum((y * y).sum(), group)
        gb, gw, gx = torch.autograd.grad(loss, [p["b"], p["w"], xi])
        for g in (gb, gw):  # P() params: summed over the ranks
            C.all_reduce_(g, group)
        out[label] = {"grads": [gb.numpy(), gw.numpy(), gx.numpy()],
                      "hops": C.read()["ops"]["collective-permute"]}
    return out


def silent_rank(rank, world):
    """Rank 0 waits for a tensor that rank 1, alive, never sends."""
    if rank == 0:
        dist.recv(torch.zeros(4), src=1)
    else:
        time.sleep(600)
    return rank


def failing_rank(rank, world):
    """Rank 2 raises; the others wait in a barrier that never completes."""
    if rank == 2:
        raise ValueError("rank 2 gives up")
    dist.barrier()
    return rank


def late_injection_spmd_rank(rank, world, *args):
    """``chip_smoke.spmd_rank`` with a planted fault: stage 0 injects, at
    each tick, the tokens it was given at the tick before (zeros at the
    first), so every microbatch meets its labels one tick late."""
    import chip_smoke

    plain, seen = spmd.embed, []

    def late(table, tokens, cfg):
        seen.append(tokens)
        return plain(table, seen[-2] if len(seen) > 1 else torch.zeros_like(tokens),
                     cfg)
    spmd.embed = late
    return chip_smoke.spmd_rank(rank, world, *args)
