#!/usr/bin/env python3
"""Run one benchmark cell once, on the card, and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix,
limits and per-layer metrics are found by name (``bench/spec.py``).

Set-up (``setup_s``, from process start to the first timed step): the
program's ``ModelConfig`` from the configuration file, fp32 params in the
layout of the configuration's model module (``bench/spec.py``) on the
card and ``distinct_batches`` token batches from ``--seed``
(``bench/inputs.py``), ``repro_torch.pipeline.PipelineExecutor`` with the
traffic's schedule, and ``warmup_steps`` steps at the cell's own shapes,
which build or load the flash kernels (``src/repro_torch/kernels/_build``,
inside the checkout).

The window: ``ex.step(params, batch)`` back to back, each step on the next
batch and ending in ``torch.cuda.synchronize()``, until ``--seconds`` have
passed; the step that crosses the deadline is finished and counted. With
``--trace 0`` it reports the cell's end-to-end metrics: ``tokens_per_s``
(tokens of all steps over the time to the end of the last one), ``mfu``
(that rate times the model module's ``flops_per_token`` over the bf16
peak), ``peak_mem_gib`` (``max_memory_allocated`` over the window, reset at
its start) and ``setup_s``. With ``--trace 1`` the window is profiled
(``torch.profiler``) for at least one step and ``TRACE_SECONDS`` or
``--seconds`` if that is less, and it reports the cell's per-layer
metrics, each read by ``bench/metrics/<name>.py``, with the device's busy
and traced seconds and a breakdown.

After the window, with the program's stash freed and the peak read, the
last step's loss and gradients and one earlier step's loss (drawn from the
seed) are held against the plain reference (the model module's
``leaf_grads`` and ``loss_only``, ``bench/check.py``), every leaf of its
``leaf_names`` (a reference that skips one raises); every number of
``check.NUMBERS`` is printed beside its limit (null where the cell sets
none) on standard error and, last, in the result line.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level module names the process may not hold when it prints a result
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the longest a traced window runs, in seconds (whole steps, at least one)
TRACE_SECONDS = 2.0
GIB = 2 ** 30


@dataclasses.dataclass
class Ctx:
    """What a per-layer metric's ``read`` gets."""
    model: Dict[str, Any]      # the configuration file's model object
    traffic: Dict[str, Any]
    module: Any                # the configuration's model module
    trace: Any                 # bench.trace.Trace of the traced window
    stats: Any                 # the last traced step's StoreStats
    tokens: int                # tokens of the traced steps


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(step, params, batches, first: int, seconds: float, dev,
            min_steps: int = 1):
    """Steps back to back from batch ``first`` until ``seconds`` have passed
    and ``min_steps`` ran. Returns (last result, losses, steps, seconds,
    index of the last batch)."""
    losses, res, j, ends = [], None, first, []
    t0 = time.perf_counter()
    while True:
        res = None  # the last step's grads go before the next step's come
        res = step(params, batches[j % len(batches)])
        _sync(dev)
        ends.append(time.perf_counter() - t0)
        losses.append(res.loss)
        j += 1
        if ends[-1] >= seconds and len(losses) >= min_steps:
            break
    return res, losses, ends, (j - 1) % len(batches)


def executor(cfg, traffic, microbatches: Optional[int] = None):
    """The program's pipelined step for ``traffic`` (its schedule, stages,
    microbatch size and recompute arm), bound to ``microbatches``."""
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.pipeline.executor import PipelineExecutor
    m = int(microbatches or traffic["microbatches"])
    return PipelineExecutor(cfg, ScheduleSpec(traffic["schedule"], int(traffic["p"]), m),
                            micro_batch=int(traffic["micro_batch"]),
                            remat=traffic["remat"])


def build(cell, seed: int, dev):
    """(the program's config with the traffic's attention arm, params,
    batches, executor) of ``cell`` on ``dev`` from ``seed``."""
    from bench import inputs, spec
    tr = cell.traffic
    cfg = dataclasses.replace(spec.model_config(cell.config), attn_impl=tr["attn_impl"])
    params = inputs.make_params(cell.module.param_shapes(cfg), seed, dev)
    batches = inputs.make_batches(tr, cfg.vocab_size, seed, dev)
    return cfg, params, batches, executor(cfg, tr)


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             step_wrapper: Optional[Callable] = None, t_start: float = T_START,
             log=print) -> Dict[str, Any]:
    """Set-up, window and check of ``cell`` (``spec.Cell``) on ``device``.
    ``step_wrapper(ex)``, where given, returns the step the window calls in
    place of ``ex.step`` (a planted fault). Returns the result object."""
    import torch

    from bench import check, flops, spec

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    t_init = time.monotonic()
    tr = cell.traffic
    model, mod = cell.config["model"], cell.module
    b, m, s = int(tr["micro_batch"]), int(tr["microbatches"]), int(tr["seq_len"])
    cfg, params, batches, ex = build(cell, seed, dev)
    step = step_wrapper(ex) if step_wrapper is not None else ex.step
    warm = int(tr["warmup_steps"])
    t_built = time.monotonic()
    _, _, warm_ends, _ = _window(step, params, batches, 0, 0.0, dev, min_steps=warm)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.monotonic() - t_start
    log(f"[bench] set-up: {t_init - t_start:.3f} s to an initialised device, "
        f"{t_built - t_init:.3f} s to params, batches and the executor, "
        f"{setup_s - (t_built - t_start):.3f} s of {warm} warm-up steps")
    tokens_a_step = b * m * s

    metrics: Dict[str, Dict[str, Any]] = {}
    extra: Dict[str, Any] = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from bench.trace import WINDOW_RANGE, Trace
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(WINDOW_RANGE):
                res, losses, ends, last = _window(
                    step, params, batches, warm, min(seconds, TRACE_SECONDS), dev)
        t_read = time.perf_counter()
        tr_ = Trace(prof)
        del prof
        ctx = Ctx(model=model, traffic=tr, module=mod, trace=tr_, stats=res.stats,
                  tokens=len(ends) * tokens_a_step)
        for metric in cell.per_layer:
            v = spec.metric_reader(metric["name"])(ctx)
            if v is not None:
                metrics[metric["name"]] = {"value": v, "unit": metric["unit"]}
        extra = {"busy_s": tr_.busy_s, "window_s": tr_.window_s}
        breakdown = tr_.breakdown()
        log(f"[bench] trace read in {time.perf_counter() - t_read:.2f} s; "
            f"{len(tr_.ops)} device ops")
        del tr_, ctx
    else:
        res, losses, ends, last = _window(step, params, batches, warm, seconds, dev)
    steps, elapsed = len(ends), ends[-1]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not trace:
        rate = steps * tokens_a_step / elapsed
        e2e = {"tokens_per_s": rate,
               "mfu": 100.0 * rate * mod.flops_per_token(model, s) / flops.PEAK_BF16,
               "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        for metric in cell.end_to_end:
            metrics[metric["name"]] = {"value": e2e[metric["name"]], "unit": metric["unit"]}
    times = sorted(b_ - a_ for a_, b_ in zip([0.0] + ends, ends))
    log(f"[bench] {cell.name} seed {seed}: set-up {setup_s:.3f} s, {steps} steps in "
        f"{elapsed:.3f} s, {steps * tokens_a_step} tokens, peak {peak / GIB:.3f} GiB; "
        f"step s min {times[0]:.4f} median {times[len(times) // 2]:.4f} max "
        f"{times[-1]:.4f}; warm-up steps {[round(x, 3) for x in warm_ends]}")

    # --- the check, with the program's stash gone and the peak read ---
    loss_vals = [float(x) for x in losses]
    failed = sum(not math.isfinite(x) for x in loss_vals)
    grads, last_loss = res.grads, loss_vals[-1]
    del res, ex, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, stats = check.compare(
        mod.leaf_grads(cfg, params, batches[last], b),
        lambda name: mod.leaf_of(grads, name), last_loss, mod.leaf_names(cfg))
    if steps > 1:  # one earlier step's loss, drawn from the seed
        i = random.Random(seed).randrange(steps - 1)
        want = mod.loss_only(cfg, params, batches[(warm + i) % len(batches)], b)
        numbers["loss_rel"] = max(numbers["loss_rel"], check.loss_rel(loss_vals[i], want))
    worst = {k: stats.worst(k)[1] for k in ("grad_norm_gap", "grad_diff")}
    log(f"[bench] check in {time.perf_counter() - t_check:.1f} s over "
        f"{len(stats.rows)} leaves; worst leaves "
        + ", ".join(f"{k} {'/'.join(v or ())}" for k, v in worst.items()))
    del grads, stats
    correct = check.verdict(numbers, cell.limits) and failed == 0

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak), **extra}
    out: Dict[str, Any] = {"correct": bool(correct), "attempted": steps, "failed": failed,
                           "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": numbers.get(k, math.inf), "limit": cell.limits.get(k)}
                       for k in dict.fromkeys(check.NUMBERS + tuple(cell.limits))}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from bench import spec
    cell = spec.load_cell(args.workload)
    import torch

    import repro_torch.pipeline.executor  # noqa: F401  (the program must be there)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", log=log)
    found = forbidden_modules()
    if found:
        print(f"[bench] the process holds {found}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
