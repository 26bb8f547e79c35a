"""Rank functions of the port's sharded-step tests, in a module of their
own: a spawned rank imports the module of its function, and this one
imports torch and the port only (no JAX, no conftest)."""
import dataclasses

import torch

from repro_torch import bridge
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import adam
from repro_torch.pipeline import collectives as C
from repro_torch.sharding import rules
from repro_torch.train.steps import make_loss_grad, make_train_step

TCFG = TrainConfig(global_batch=4, seq_len=16, remat="none")


def small_cfg(arch, impl, **kw):
    """The arch's smoke config in fp32 with the given attention arm."""
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32",
                               attn_impl=impl, **kw)


def _step_on_mesh(cfg, mesh, np_params, tokens):
    params = bridge.to_torch(np_params, "cpu")
    toks = torch.from_numpy(tokens)
    batch = {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}
    step, shardings = make_train_step(cfg, TCFG, mesh)
    ps, _, bs = shardings(params, None, batch)
    dparams = rules.distribute(params, mesh, ps)
    dbatch = rules.distribute(batch, mesh, bs)
    _, grads = make_loss_grad(cfg, TCFG, mesh)(dparams, dbatch)
    C.reset()
    new, _, metrics = step(dparams, adam.init(dparams), dbatch)
    return step, dparams, dbatch, new, dict(metrics, grads=grads), C.read()


def parity_rank(rank, world, data, model, path):
    """Each case's sharded train step on this rank of a (data, model) mesh:
    the loss, the full grads and updated params (rank 0 only) and the
    collective counter. ``path``: a pickle of {name: (arch, impl, cfg
    overrides, JAX params as numpy, tokens (B, S + 1))} (a file, so that
    spawning the ranks does not wait on a pipe carrying the params)."""
    import pickle
    with open(path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_host_mesh(data, model, "cpu")
    out = {}
    for name, (arch, impl, over, np_params, tokens) in cases.items():
        cfg = small_cfg(arch, impl, **over)
        _, _, _, new, metrics, counter = _step_on_mesh(cfg, mesh, np_params, tokens)
        full = {"grads": {p: g.full_tensor() for p, g in
                          T.leaves_with_paths(metrics["grads"])},
                "params": {p: t.full_tensor() for p, t in T.leaves_with_paths(new)}}
        res = {"loss": float(metrics["total"].full_tensor()), "counter": counter}
        if rank == 0:
            res.update({k: {p: t.numpy() for p, t in v.items()} for k, v in full.items()})
        out[name] = res
    return out


def refusal_rank(rank, world, np_params, tokens):
    """The sharded step refuses a plain-tensor param and a batch leaf of the
    wrong placements: the exceptions' types."""
    from torch.distributed.tensor import Replicate
    mesh = make_host_mesh(2, 2, "cpu")
    cfg = small_cfg("llama-65b", "flash")
    step, dparams, dbatch, _, _, _ = _step_on_mesh(cfg, mesh, np_params, tokens)
    got = []
    plain = dict(dparams, final_norm={"scale": dparams["final_norm"]["scale"].full_tensor()})
    wrong = dict(dbatch, tokens=dbatch["tokens"].redistribute(mesh, [Replicate(), Replicate()]))
    for p, b in ((plain, dbatch), (dparams, wrong)):
        try:
            step(p, adam.init(dparams), b)
            got.append(None)
        except (TypeError, ValueError) as e:
            got.append(type(e).__name__)
    return got


def faithful_and_faulty_rank(rank, world, t, device, refs):
    """``chip_smoke.sharded_rank`` twice in this rank: faithful, then with
    rank 1's ``wq`` shard rolled by one head. Each run gets its own copies
    of the reference's dicts, which it clears as it goes."""
    import chip_smoke as cs
    loss, grads, params = refs["full"]
    return [cs.sharded_rank(rank, world, t, device,
                            {"full": (loss, dict(grads), dict(params))},
                            fault=fault)
            for fault in (False, True)]
