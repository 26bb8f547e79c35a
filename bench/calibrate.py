#!/usr/bin/env python3
"""The readings that a cell's limits are set between, on the card, at the
cell's own size, in one process:

    python3 bench/calibrate.py --workload <cell> --seeds 101 102 ... \
        [--control 3] [--faults 3] [--out FILE]

For each seed it builds the cell as ``run.py`` does (params, batches, the
program's executor, the warm-up steps), runs two more steps and reads the
numbers of ``check.py`` as a run of two window steps reads them, against
the plain reference of the configuration's model module: the lower
readings. On the first ``--control`` seeds it reads the control (that
reference with float8 products, ``faults.control``) in the program's
place; on the first ``--faults`` seeds the planted faults: the previous
step's result returned (``stale``), half of the batch left out
(``half_batch``), and, from the same pass as the sound run, one leaf's
gradient negated (``negated``; a leaf drawn from the seed among those at
or above the median reference norm). A zeroed gradient (a state left
unchanged) reads 1 on both gradient numbers by their definition and needs
no run. One JSON line a reading goes to ``--out`` and standard output.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import math
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def negated_reading(stats, name):
    """grad_diff with leaf ``name`` negated, from the sound run's stats:
    ||-g - r||^2 = ||g||^2 + ||r||^2 + 2 <g, r>."""
    med = stats.median_ref()
    g, r, _, dot = stats.rows[name]
    flipped = math.sqrt(max(g * g + r * r + 2 * dot, 0.0)) / max(r, med)
    others = max(diff / max(rr, med) for n, (_, rr, diff, _) in stats.rows.items()
                 if n != name)
    return max(flipped, others)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at a tiny size")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose cells to read")
    args = ap.parse_args(argv)
    from bench import spec
    cell = spec.load_cell(args.workload, Path(args.root))
    import torch

    from bench import check, faults
    from bench.run import build

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    b, mod = int(cell.traffic["micro_batch"]), cell.module
    warm = int(cell.traffic["warmup_steps"])
    out = open(args.out, "a") if args.out else None

    def emit(seed, kind, numbers, t0, **extra):
        row = {"cell": cell.name, "seed": seed, "kind": kind, **numbers,
               "seconds": time.perf_counter() - t0, **extra}
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def run_step(step, params, batch):
        res = step(params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return res

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    for n, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        cfg, params, batches, ex = build(cell, seed, dev)
        for j in range(warm):  # one step's grads at a time
            run_step(ex.step, params, batches[j])
        early, late = batches[warm], batches[warm + 1]
        loss_early = float(run_step(ex.step, params, early).loss)
        res = run_step(ex.step, params, late)
        loss_late, grads = float(res.loss), res.grads
        del res
        free()
        want_early = mod.loss_only(cfg, params, early, b)
        numbers, stats = check.compare(mod.leaf_grads(cfg, params, late, b),
                                       lambda name: mod.leaf_of(grads, name), loss_late,
                                       mod.leaf_names(cfg))
        numbers["loss_rel"] = max(numbers["loss_rel"], check.loss_rel(loss_early, want_early))
        worst = {k: "/".join(stats.worst(k)[1]) for k in ("grad_norm_gap", "grad_diff")}
        emit(seed, "program", numbers, t0, worst=worst)
        del grads
        free()
        if n < args.faults:
            t1 = time.perf_counter()
            med = stats.median_ref()
            big = sorted(name for name, (_, r, _, _) in stats.rows.items() if r >= med)
            name = random.Random(seed).choice(big)
            emit(seed, "negated", {"grad_diff": negated_reading(stats, name)}, t1,
                 leaf="/".join(name))
        del stats
        if n < args.control:
            t1 = time.perf_counter()
            nums, _ = check.compare(*check.lockstep(
                mod.leaf_grads(cfg, params, late, b),
                mod.leaf_grads(cfg, params, late, b, fp8=True)), mod.leaf_names(cfg))
            nums["loss_rel"] = max(nums["loss_rel"], check.loss_rel(
                mod.loss_only(cfg, params, early, b, fp8=True), want_early))
            emit(seed, "control", nums, t1)
        if n < args.faults:
            for kind, wrap in (("stale", faults.stale(cell)),
                               ("half_batch", faults.half_batch(cell))):
                t1 = time.perf_counter()
                step = wrap(ex)
                if kind == "stale":  # its first result is the early batch's
                    run_step(step, params, early)
                res = run_step(step, params, late)
                got_loss, grads = float(res.loss), res.grads
                del res, step
                free()
                nums, _ = check.compare(mod.leaf_grads(cfg, params, late, b),
                                        lambda name: mod.leaf_of(grads, name), got_loss,
                                        mod.leaf_names(cfg))
                emit(seed, kind, nums, t1)
                del grads
                free()
        del cfg, params, batches, ex
        free()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
