"""Pipelined training: the twin of the JAX package's
``examples/bpipe_pipeline.py``. Trains one model under GPipe / 1F1B /
BPipe — plain, with the other two residency mechanisms on the 1F1B
schedule, and interleaved (v virtual chunks per stage) when the microbatch
count allows — and prints each arm's losses, per-stage activation-stash
peaks and moves: the paper's Fig. 1, live.

    python -m repro_torch.launch.pipeline --device cpu    # reduced qwen, fp32
    python -m repro_torch.launch.pipeline                 # the same on the card

The example's flags (``--stages``, ``--micro``, ``--steps``, ``--v``,
``--plan``) plus ``--arch``, ``--layers``, ``--batch``, ``--seq`` and
``--device``, as ``launch.train`` takes them. Without ``--arch`` the model
is the example's, reduced qwen1.5-0.5b in fp32; ``--arch`` names a config
at full width in its own dtype. Without ``--layers`` the depth is the
example's max(2, v) * stages. Attention is always the port's flash
kernels. Each arm starts from the same params (seed 0, drawn on the CPU so
that every device gets the same), calls ``PipelineExecutor.step`` and then
``optim/adam.update`` (lr 1e-3, as the example) on every step.
``--plan auto`` needs the planner, which is not ported yet (ROADMAP A7).
Without ``--device cpu`` it runs on the card and raises when there is
none.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import schedule as S
from repro_torch.core.plan import ScheduleSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.pipeline import PipelineExecutor


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--v", type=int, default=2,
                    help="virtual chunks per stage for interleaved kinds")
    ap.add_argument("--plan", default="all", choices=["all", "auto"],
                    help="all: sweep every kind; auto: the planner's pick "
                         "(not ported yet)")
    ap.add_argument("--arch", default=None,
                    help="model config at full width (default: the "
                         "example's reduced qwen1.5-0.5b in fp32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: max(2, v) * stages)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def arms(p: int, m: int, v: int):
    """The example's arms: (kind, residency) pairs, interleaved kinds only
    when m is a multiple of p and v >= 2."""
    out = [("gpipe", "none"), ("1f1b", "none"), ("bpipe", "none"),
           ("1f1b", "host_offload"), ("1f1b", "selective_recompute")]
    if m % p == 0 and v >= 2:
        out += [("1f1b_interleaved", "none"), ("bpipe_interleaved", "none")]
    return out


def arm_label(spec: ScheduleSpec) -> str:
    """The arm's name in the printout and in ``main``'s result."""
    return spec.kind if spec.residency in ("none", "bpipe_swap") \
        else f"{spec.kind}+{spec.residency}"


def main(argv=None):
    """Run every arm; returns {"cfg", "arms": {label: {"losses", "stats",
    "params"}}}, each arm's params after its last Adam update."""
    args = parse_args(argv)
    if args.plan == "auto":
        raise NotImplementedError(
            "--plan auto needs the planner and its calibration, which are "
            "not ported yet (ROADMAP A7)")
    device = resolve_device(args.device)
    p = args.stages
    if args.arch:
        cfg = get_config(args.arch)
    else:
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                  dtype="float32")
    cfg = dataclasses.replace(
        cfg, attn_impl="flash",
        num_layers=args.layers or max(2, args.v) * p)
    # drawn on the CPU, so a seed gives the same params on every device
    params = T.tree_map(lambda t: t.to(device), M.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu"))
    dc = DataConfig(batch=args.batch, seq_len=args.seq)
    tcfg = TrainConfig(global_batch=args.batch, steps=args.steps,
                       warmup_steps=1, learning_rate=1e-3)
    m = args.batch // args.micro
    print(f"pipeline: {cfg.name} {cfg.num_layers} layers {cfg.dtype} on "
          f"{device}, p={p}, m={m} microbatches of {args.micro} x {args.seq}, "
          f"BPipe cap = ceil((p+2)/2) = {S.bpipe_cap(p)}, "
          f"interleaved (v={args.v}) cap = "
          f"{S.bpipe_interleaved_cap(p, args.v)}")

    out = {}
    for kind, res in arms(p, m, args.v):
        spec = ScheduleSpec(kind, p, m, v=args.v, residency=res)
        label = arm_label(spec)
        ex = PipelineExecutor(cfg, spec, micro_batch=args.micro)
        params_k = T.tree_map(torch.clone, params)
        opt = adam.init(params_k)
        losses, stats = [], None
        for i in range(args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in make_batch(cfg, dc, i).items()}
            r = ex.step(params_k, batch)
            params_k, opt, _ = adam.update(params_k, r.grads, opt, tcfg)
            losses.append(float(r.loss))
            stats = r.stats
        peaks = [stats.peak_local[i] for i in range(p)]
        print(f"{label:>6}: losses {['%.3f' % x for x in losses]}")
        moves = (f"evictions={stats.evictions} loads={stats.loads}"
                 if stats.offloads == stats.drops == 0 else
                 f"offloads={stats.offloads} fetches={stats.fetches} "
                 f"drops={stats.drops} recomputes={stats.recomputes}")
        print(f"        peak stash/stage {peaks}  {moves} "
              f"moved={stats.bytes_moved / 2**20:.1f}MiB(modelled)")
        out[label] = {"losses": losses, "stats": stats, "params": params_k}
    return {"cfg": cfg, "arms": out}


if __name__ == "__main__":
    main()
