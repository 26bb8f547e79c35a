#!/usr/bin/env python3
"""What saving the bf16 copy of each weight for the backward cost the
PyTorch port, on one CUDA card: the pipelined step and the training step
with every weight product taken two ways.

    python3 chip_cast_ab.py

The port's layers multiply by their fp32 weights through
``layers.cast_matmul``, which saves the fp32 weight and casts it again in
the backward. The plain product ``x @ w.to(x.dtype)`` (the earlier code,
rebuilt here; the same values, ``tests/test_torch_layers.py``) lets
autograd save the cast copy instead. The script runs the pipelined step of
``chip_smoke.py``'s phase 9 (llama-65b at full width, 4 layers, p 4, m 4 x
1 x 2048, 1f1b, flash) and its training step (4 layers, b 1 x 2048, Adam),
warms each up once per arm, then times one step of each arm in the order
cast_matmul, plain, plain, cast_matmul. For the pipelined step it prints
each stash unit's saved bytes (``Box.nbytes()``) and the memory allocated
on the card as each unit's forward ends (its largest value is the stash's
peak), beside ``max_memory_allocated`` over the step. It prints the card's
name and power limit beside the numbers, and exits non-zero without a card.
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH, LAYERS, P, M, SEQ = "llama-65b", 4, 4, 4, 2048
ORDER = ("cast_matmul", "plain", "plain", "cast_matmul")


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_cast_ab: src/repro_torch is not beside this script")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_cast_ab: torch.cuda.is_available() is false")

    from repro_torch import serve
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.memory import offload as mem_offload
    from repro_torch.models import attention, layers
    from repro_torch.models import model as Mdl
    from repro_torch.pipeline import PipelineExecutor
    from repro_torch.train.steps import init_all, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = serve.config_for(ARCH, layers=LAYERS, attn_impl="flash")
    cast_matmul = layers.cast_matmul

    def plain(x, w):
        return x @ w.to(x.dtype)

    def use(name):
        fn = cast_matmul if name == "cast_matmul" else plain
        layers.cast_matmul = attention.cast_matmul = fn

    units = []

    class Box(mem_offload.Box):
        def hooks(self):
            @contextlib.contextmanager
            def filled():
                with super(Box, self).hooks():
                    yield
                units.append((self.nbytes(), torch.cuda.memory_allocated()))
            return filled()

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    gib = 2.0 ** 30
    plain_box = mem_offload.Box
    try:
        # the pipelined step
        params = Mdl.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, DataConfig(batch=M, seq_len=SEQ), 0).items()}
        ex = PipelineExecutor(cfg, ScheduleSpec("1f1b", P, M), remat="flash")
        mem_offload.Box = Box
        for name in ("cast_matmul", "plain"):
            use(name)
            ex.step(params, batch)
        print(f"pipelined step: {cfg.name} {cfg.num_layers} layers d{cfg.d_model}, "
              f"1f1b p{P} m{M} x 1 x {SEQ}, one step each in turns c, p, p, c:")
        for name in ORDER:
            use(name)
            units.clear()
            s, peak = timed(lambda: ex.step(params, batch))
            saved = [n for n, _ in units]
            print(f"  {name:11s} {1e3 * s:9.2f} ms; saved bytes per unit "
                  f"{min(saved) / gib:.3f}-{max(saved) / gib:.3f} GiB over "
                  f"{len(saved)} units; allocated as a unit's forward ends at most "
                  f"{max(a for _, a in units) / gib:.2f} GiB; max_memory_allocated "
                  f"{peak / gib:.2f} GiB")
        mem_offload.Box = plain_box
        del ex, params, batch
        torch.cuda.empty_cache()

        # the training step
        tcfg = dataclasses.replace(TrainConfig(), steps=5, seq_len=SEQ)
        step_fn = make_train_step(cfg, tcfg)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, DataConfig(batch=1, seq_len=SEQ), 0).items()}
        state = {}
        state["p"], state["o"] = init_all(cfg, 0, dev)

        def step():
            state["p"], state["o"], _ = step_fn(state["p"], state["o"], batch)

        for name in ("cast_matmul", "plain"):
            use(name)
            step()
        print(f"training step: {cfg.name} {cfg.num_layers} layers b1 x {SEQ} with "
              f"Adam, one step each in turns c, p, p, c:")
        for name in ORDER:
            use(name)
            s, peak = timed(step)
            print(f"  {name:11s} {1e3 * s:9.2f} ms; max_memory_allocated "
                  f"{peak / gib:.2f} GiB")
    finally:
        mem_offload.Box = plain_box
        use("cast_matmul")
    print(f"card {smi}")


if __name__ == "__main__":
    main()
