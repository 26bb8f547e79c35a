#!/usr/bin/env python3
"""Peak memory and time of one training step of the PyTorch port with the
stacked layer params' rows taken two ways, on one CUDA card.

    python3 chip_rows_ab.py

``PatternStack`` keeps each pattern position's layer params stacked along
a leading axis and hands each layer its row. By ``unbind`` (the port's
``blocks._rows``) the backward stacks each leaf's row grads once; by
``select`` (``v[i]`` per layer and leaf, the earlier code, rebuilt here)
each row's backward allocates a zeroed tensor of the whole stack. The
script trains llama-65b at full width, 4 layers, batch 1 x 2048 (the
training path of ``chip_smoke.py``), warms up with two steps, then times
one step each in the order unbind, select, select, unbind, with
``torch.cuda.max_memory_allocated`` reset before each. It prints the card's
name and power limit beside the numbers, and exits non-zero without a card.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH, LAYERS, BATCH, SEQ = "llama-65b", 4, 1, 2048


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_rows_ab: src/repro_torch is not beside this script")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_rows_ab: torch.cuda.is_available() is false")
    import dataclasses

    from repro_torch import serve
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import blocks
    from repro_torch.train.steps import init_all, make_train_step

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = serve.config_for(ARCH, layers=LAYERS, attn_impl="flash")
    tcfg = dataclasses.replace(TrainConfig(), steps=5, seq_len=SEQ)
    step_fn = make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, DataConfig(batch=BATCH, seq_len=SEQ), 0).items()}
    box = {}
    box["p"], box["o"] = init_all(cfg, 0, dev)

    def step():
        box["p"], box["o"], _ = step_fn(box["p"], box["o"], batch)

    by_unbind = blocks._rows

    def by_select(tree, n):
        return [blocks._row(tree, i) for i in range(n)]

    for _ in range(2):
        step()
    seen = {"unbind": [], "select": []}
    try:
        for name, rows in (("unbind", by_unbind), ("select", by_select),
                           ("select", by_select), ("unbind", by_unbind)):
            blocks._rows = rows
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            seen[name].append((time.perf_counter() - t0,
                               torch.cuda.max_memory_allocated()))
    finally:
        blocks._rows = by_unbind
    print(f"{cfg.name} {cfg.num_layers} layers d{cfg.d_model} b{BATCH} x {SEQ}, "
          f"one train step each, in turns u, s, s, u:")
    for name, runs in seen.items():
        print(f"rows by {name}: step "
              + ", ".join(f"{s_ * 1e3:.2f} ms" for s_, _ in runs)
              + "; peak " + ", ".join(f"{p_ / 2**30:.2f} GiB" for _, p_ in runs)
              + f"; card {smi}")


if __name__ == "__main__":
    main()
