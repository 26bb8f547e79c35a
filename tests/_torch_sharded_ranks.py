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


def _distributed(cfg, mesh, np_params, np_batch):
    """(the mesh's train step, DTensor params, DTensor batch)."""
    params = bridge.to_torch(np_params, "cpu")
    batch = {k: torch.from_numpy(v).contiguous() for k, v in np_batch.items()}
    step, shardings = make_train_step(cfg, TCFG, mesh)
    ps, _, bs = shardings(params, None, batch)
    return step, rules.distribute(params, mesh, ps), rules.distribute(batch, mesh, bs)


def _step_on_mesh(cfg, mesh, np_params, np_batch):
    step, dparams, dbatch = _distributed(cfg, mesh, np_params, np_batch)
    _, grads = make_loss_grad(cfg, TCFG, mesh)(dparams, dbatch)
    C.reset()
    new, _, metrics = step(dparams, adam.init(dparams), dbatch)
    return step, dparams, dbatch, new, dict(metrics, grads=grads), C.read()


def parity_rank(rank, world, data, model, path):
    """Each case's sharded train step on this rank of a (data, model) mesh:
    the loss, the full grads and updated params (rank 0 only) and the
    collective counter. ``path``: a pickle of {name: (arch, impl, cfg
    overrides, JAX params as numpy, the batch as numpy)} (a file, so that
    spawning the ranks does not wait on a pipe carrying the params)."""
    import pickle
    with open(path, "rb") as f:
        cases = pickle.load(f)
    mesh = make_host_mesh(data, model, "cpu")
    out = {}
    for name, (arch, impl, over, np_params, np_batch) in cases.items():
        cfg = small_cfg(arch, impl, **over)
        _, _, _, new, metrics, counter = _step_on_mesh(cfg, mesh, np_params, np_batch)
        full = {"grads": {p: g.full_tensor() for p, g in
                          T.leaves_with_paths(metrics["grads"])},
                "params": {p: t.full_tensor() for p, t in T.leaves_with_paths(new)}}
        res = {"loss": float(metrics["total"].full_tensor()), "counter": counter}
        if rank == 0:
            res.update({k: {p: t.numpy() for p, t in v.items()} for k, v in full.items()})
        out[name] = res
    return out


def accum_rank(rank, world, np_params, np_batch, splits):
    """The dry run's gradient accumulation on a (2, 2) mesh of reduced
    llama-65b, against the single-shot grads of the same batch: {"single"
    or a number of microbatches: {"loss", "grads" (full, rank 0 only),
    "moves" (the batch redistributions the split recorded)}}."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import dryrun
    mesh = make_host_mesh(2, 2, "cpu")
    cfg = small_cfg("llama-65b", "flash")
    _, dparams, dbatch = _distributed(cfg, mesh, np_params, np_batch)
    def full(grads):  # a collective on every rank, kept on rank 0
        got = {p: g.full_tensor().numpy() for p, g in T.leaves_with_paths(grads)}
        return got if rank == 0 else None

    loss, grads = make_loss_grad(cfg, TCFG, mesh)(dparams, dbatch)
    out = {"single": {"loss": float(loss.full_tensor()), "grads": full(grads)}}
    for n in splits:
        rules.REDISTRIBUTIONS.clear()
        with rules.set_mesh(mesh), implicit_replication():
            loss, grads = dryrun.accumulated_grads(dparams, dbatch, cfg,
                                                   TCFG.remat, n)
        out[n] = {"loss": float(loss.full_tensor()), "grads": full(grads),
                  "moves": [str(e) for e in rules.REDISTRIBUTIONS
                            if e[0] == "accum_batch"]}
    return out


def refusal_rank(rank, world, np_params, np_batch):
    """The sharded step refuses a plain-tensor param and a batch leaf of the
    wrong placements: the exceptions' types."""
    from torch.distributed.tensor import Replicate
    mesh = make_host_mesh(2, 2, "cpu")
    cfg = small_cfg("llama-65b", "flash")
    step, dparams, dbatch, _, _, _ = _step_on_mesh(cfg, mesh, np_params, np_batch)
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


def gqa_rank(rank, world, seed):
    """Attention on a (1, 4) mesh where 2 batch rows and 2 kv heads do not
    divide "model" but 8 q heads do (2 a rank, both in one kv group of 4):
    ``_sdpa`` and ``_flash`` on DTensors (q heads sharded, k and v on
    head_dim as the rules relocate them) against the same attention on the
    whole tensors: {arm: the output's placements, the moves recorded, the
    largest error of the values and of the grads of a weighted sum, and the
    largest |want|}."""
    import numpy as np
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import attention as A
    mesh = make_host_mesh(1, 4, "cpu")
    cfg = small_cfg("llama-65b", "flash")
    rng = np.random.default_rng(seed)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 8, 8, 16), (2, 8, 2, 16), (2, 8, 2, 16),
                            (2, 8, 8, 16)))
    pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)
    arms = {"sdpa": lambda q, k, v: A._sdpa(q, k, v, cfg, pos, pos, causal=True,
                                            window=0),
            "flash": lambda q, k, v: A._flash(q, k, v, cfg, window=0)}
    out = {}
    for name, f in arms.items():
        rules.REDISTRIBUTIONS.clear()
        whole = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = f(*whole)
        want_g = torch.autograd.grad((want * w).sum(), whole)
        dq = distribute_tensor(q, mesh, [Shard(0), Shard(2)], src_data_rank=None)
        dk, dv = (distribute_tensor(t, mesh, [Shard(0), Shard(3)], src_data_rank=None)
                  for t in (k, v))
        leaves = [t.requires_grad_(True) for t in (dq, dk, dv)]
        got = f(*leaves)
        dw = distribute_tensor(w, mesh, list(got.placements), src_data_rank=None)
        got_g = torch.autograd.grad((got * dw).sum(), leaves)
        out[name] = {"placements": [str(p) for p in got.placements],
                     "moves": sorted({e[0] for e in rules.REDISTRIBUTIONS}),
                     "err": max(float((a.full_tensor() - b).abs().max())
                                for a, b in zip([got, *got_g], [want, *want_g])),
                     "scale": max(float(b.abs().max()) for b in [want, *want_g])}
    return out


def rope_rank(rank, world, seed):
    """``attention._rope`` on a (2, 2) mesh of 4 batch rows, 8 positions, 4
    q heads and 2 kv heads, for each pair of q and k placements: batch rows
    and heads sharded, the sequence and heads, and k's head_dim (as the
    rules relocate it where the kv heads do not divide), against
    ``rope_qk`` on the whole tensors: {case: the outputs' placements, the
    moves recorded, the types ``rope_qk`` saw, the largest error of the
    values and of the grads of a weighted sum, and the largest |want|}."""
    import numpy as np
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.models import attention as A
    mesh = make_host_mesh(2, 2, "cpu")
    rng = np.random.default_rng(seed)
    q, k, wq, wk = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    for s in ((4, 8, 4, 16), (4, 8, 2, 16)) * 2)
    pos = torch.from_numpy(rng.integers(0, 4096, (4, 8)).astype(np.int32))
    theta = 10_000.0
    cases = {"rows": ((Shard(0), Shard(2)), (Shard(0), Shard(2))),
             "sequence": ((Shard(1), Shard(2)), (Shard(1), Shard(2))),
             "head_dim": ((Shard(0), Shard(2)), (Shard(0), Shard(3)))}
    seen = []
    real = A.rope_qk

    def spied(a, b, p, t):
        seen.extend(type(x).__name__ for x in (a, b, p))
        return real(a, b, p, t)

    A.rope_qk = spied
    out = {}
    try:
        whole = [t.clone().requires_grad_(True) for t in (q, k)]
        want = real(*whole, pos, theta)
        want_g = torch.autograd.grad((want[0] * wq).sum() + (want[1] * wk).sum(),
                                     whole)
        for name, (qp, kp) in cases.items():
            rules.REDISTRIBUTIONS.clear()
            seen.clear()
            leaves = [distribute_tensor(t, mesh, list(pl), src_data_rank=None)
                      .requires_grad_(True) for t, pl in ((q, qp), (k, kp))]
            got = A._rope(*leaves, pos, theta)
            dw = [distribute_tensor(w, mesh, list(g.placements), src_data_rank=None)
                  for w, g in zip((wq, wk), got)]
            got_g = torch.autograd.grad(sum((g * w).sum() for g, w in zip(got, dw)),
                                        leaves)
            out[name] = {
                "placements": [[str(p) for p in g.placements] for g in got],
                "moves": sorted({e[0] for e in rules.REDISTRIBUTIONS}),
                "seen": sorted(set(seen)),
                "err": max(float((a.full_tensor() - b).abs().max())
                           for a, b in zip([*got, *got_g], [*want, *want_g])),
                "scale": max(float(b.abs().max()) for b in [*want, *want_g])}
    finally:
        A.rope_qk = real
    return out
