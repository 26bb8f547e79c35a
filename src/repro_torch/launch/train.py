"""Training launcher: the twin of the JAX package's ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch llama-65b --layers 4 \\
        --batch 1 --seq 2048 --steps 5                # full width, on the card
    python -m repro_torch.launch.train --arch llama-65b --reduced \\
        --device cpu --steps 2

The same flags as the twin (without a mesh: one device), plus ``--layers``
to cut the depth and ``--device``. Unlike the twin, which keeps the
config's attention arm, it always trains with ``attn_impl="flash"`` (the
port's kernels). Without ``--device cpu`` it runs on the card and raises
when there is none. Checkpoints (``--ckpt``) are in the twin's format and resume
automatically.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.train.steps import init_all, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the family (CPU-friendly)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--micro-batch", type=int, default=0,
                    help="paper's b: grad-accumulation microbatch (0=off)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none",
                    choices=["none", "attn", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Train; returns {"cfg", "params", "opt", "steps"}, where each entry
    of "steps" holds that step's loss, grad norm, lr and its seconds on
    the host clock, ending in a device synchronise."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attn_impl="flash",
                              num_layers=args.layers or cfg.num_layers)
    tcfg = TrainConfig(
        global_batch=args.batch, micro_batch=args.micro_batch or args.batch,
        seq_len=args.seq, steps=args.steps,
        warmup_steps=max(args.steps // 20, 5), learning_rate=args.lr,
        remat=args.remat, seed=args.seed)

    params, opt = init_all(cfg, args.seed, device)
    start_step = 0
    if args.ckpt and os.path.exists(args.ckpt):
        state = ckpt.restore(args.ckpt, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        start_step = int(opt.step)
        print(f"[resume] {args.ckpt} @ step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    dc = DataConfig(batch=args.batch, seq_len=args.seq, seed=args.seed)
    n_params = cfg.param_count()
    print(f"[train] {cfg.name}  ~{n_params/1e6:.0f}M params  "
          f"B={args.batch} s={args.seq} remat={args.remat} "
          f"attn={cfg.attn_impl} layers={cfg.num_layers} device={device}")

    steps = []
    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in make_batch(cfg, dc, i).items()}
        _sync(device)
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch)
        _sync(device)
        steps.append({"step": i, "s": time.perf_counter() - ts,
                      **{k: float(m[k]) for k in ("loss", "grad_norm", "lr")}})
        if i % args.log_every == 0 or i == args.steps - 1:
            dt = (time.perf_counter() - t0) / max(i - start_step + 1, 1)
            print(f"step {i:5d}  loss {steps[-1]['loss']:.4f}  "
                  f"gnorm {steps[-1]['grad_norm']:.2f}  "
                  f"lr {steps[-1]['lr']:.2e}  {dt:.2f}s/step", flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt, {"params": params, "opt": opt})
    if args.ckpt:
        ckpt.save(args.ckpt, {"params": params, "opt": opt})
        print(f"[done] checkpoint -> {args.ckpt}")
    return {"cfg": cfg, "params": params, "opt": opt, "steps": steps}


if __name__ == "__main__":
    main()
