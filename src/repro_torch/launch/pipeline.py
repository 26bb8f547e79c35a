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

``--plan auto`` runs the example's planner loop instead of every arm: the
planner picks the schedule and micro batch under a toy budget (1.2 x the
memory model's 1F1B stage bytes at b 1, ``--batch`` rows of ``--seq``
tokens), the executor runs it, the last step is traced, and the trace is
fitted (``planner.calibrate.fit_trace``) and replayed through the simulator
(plan -> build -> execute -> trace -> recalibrate).

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
from repro_torch.core import memory_model as MM
from repro_torch.core import schedule as S
from repro_torch.core.notation import Notation
from repro_torch.core.plan import ScheduleSpec
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import model as M
from repro_torch.optim import adam
from repro_torch.pipeline import PipelineExecutor
from repro_torch.planner import (SearchSpace, calibrate, plan_config,
                                 recommend, report)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--v", type=int, default=2,
                    help="virtual chunks per stage for interleaved kinds")
    ap.add_argument("--plan", default="all", choices=["all", "auto"],
                    help="all: sweep every kind; auto: the planner's pick, "
                         "then trace + recalibrate")
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


def auto_plan(cfg, p, v, batch_rows, seq):
    """Ask the planner for the schedule instead of picking one by hand."""
    n = Notation(a=cfg.num_heads, b=1, h=cfg.d_model, l=cfg.num_layers,
                 s=seq, v=cfg.vocab_size, B=batch_rows, p=p, t=1)
    # a toy budget tight enough that fat stashes actually prune
    budget = 1.2 * MM.max_stage_bytes(n, "none", "1f1b", cfg)
    search = SearchSpace(attentions=("none",), vs=(v,) if v >= 2 else (2,))
    ranked = plan_config(n, cfg, budget, search=search, workspace=0.0)
    print(f"planner: {len(ranked)} candidates under "
          f"{budget / 2**20:.0f} MiB/device")
    print(report.format_table(ranked, top=6))
    print(report.recommendation_line(cfg.name, ranked, "none"))
    return recommend(ranked, "none")


def arm_label(spec: ScheduleSpec) -> str:
    """The arm's name in the printout and in ``main``'s result."""
    return spec.kind if spec.residency in ("none", "bpipe_swap") \
        else f"{spec.kind}+{spec.residency}"


def main(argv=None):
    """Run every arm, or the planner's pick; returns {"cfg", "arms": {label:
    {"losses", "stats", "params"}}}, each arm's params after its last Adam
    update. Under ``--plan auto`` the result also holds "plan" (the
    ``RankedPlan``) and its arm "costs" (fitted from the traced last step)
    and "replayed" (the simulator's run of the spec under them)."""
    args = parse_args(argv)
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

    result = {"cfg": cfg}
    if args.plan == "auto":
        best = auto_plan(cfg, p, args.v, args.batch, args.seq)
        assert best is not None, "no feasible plan under the toy budget"
        args.micro = best.cand.b
        specs = [best.cand.spec(p)]
        result["plan"] = best
    else:
        specs = [ScheduleSpec(kind, p, m, v=args.v, residency=res)
                 for kind, res in arms(p, m, args.v)]
    out = {}
    for spec in specs:
        label = arm_label(spec)
        ex = PipelineExecutor(cfg, spec, micro_batch=args.micro)
        params_k = T.tree_map(torch.clone, params)
        opt = adam.init(params_k)
        losses, stats, events = [], None, None
        for i in range(args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in make_batch(cfg, dc, i).items()}
            trace = args.plan == "auto" and i == args.steps - 1
            r = ex.step(params_k, batch, trace=trace)
            params_k, opt, _ = adam.update(params_k, r.grads, opt, tcfg)
            losses.append(float(r.loss))
            stats = r.stats
            events = r.events or events
        peaks = [stats.peak_local[i] for i in range(p)]
        print(f"{label:>6}: losses {['%.3f' % x for x in losses]}")
        moves = (f"evictions={stats.evictions} loads={stats.loads}"
                 if stats.offloads == stats.drops == 0 else
                 f"offloads={stats.offloads} fetches={stats.fetches} "
                 f"drops={stats.drops} recomputes={stats.recomputes}")
        print(f"        peak stash/stage {peaks}  {moves} "
              f"moved={stats.bytes_moved / 2**20:.1f}MiB(modelled)")
        out[label] = {"losses": losses, "stats": stats, "params": params_k}
        if events:
            # close the loop: trace -> recalibrate -> simulate
            costs = calibrate.fit_trace(events, v=ex.v, b=args.micro)
            replayed = calibrate.replay(costs, spec)
            print(f"        recalibrated from trace: Tf={costs.Tf * 1e3:.1f}ms "
                  f"Tb={costs.Tb * 1e3:.1f}ms -> simulated step "
                  f"{replayed.makespan * 1e3:.0f}ms "
                  f"(traced step {max(e.end for e in events) * 1e3:.0f}ms)")
            out[label].update(costs=costs, replayed=replayed)
    result["arms"] = out
    return result


if __name__ == "__main__":
    main()
