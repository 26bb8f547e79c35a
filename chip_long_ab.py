#!/usr/bin/env python3
"""What sequence slicing buys a long sequence on one CUDA card: the PyTorch
port's pipelined step at 4 x 8192 tokens, unsliced and at c 2 and c 4.

    python3 chip_long_ab.py

The script runs the pipelined step of ``chip_smoke.py``'s phase 12
long-context run (llama-65b at full width, 4 layers, p 4, m 4 x 1 x 8192,
1f1b, flash, fp32 params, random weights from a seed) with
``ScheduleSpec.seq_chunks`` 1, 2 and 4 on the same params and batch. It
warms each arm up with one step, then times one step of each in the order
1, 2, 4, 4, 2, 1, each from an emptied allocator cache. For each it prints
the step time and tokens/s; as each stash unit's forward ends, the memory
allocated on the card and the saved bytes of all live units' boxes (the
real stash; a slice's own KV is in its box), at their largest;
``max_memory_allocated`` and ``max_memory_reserved`` over the step; the
peak stash per stage and the loss. An arm that runs out of device memory
is reported as not fitting and left out of the later turns. It prints the
card's name and power limit beside the numbers, and exits non-zero without
a card.
"""
import contextlib
import os
import subprocess
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
ARCH, LAYERS, P, M, SEQ = "llama-65b", 4, 4, 4, 8192
ORDER = (1, 2, 4, 4, 2, 1)


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_long_ab: src/repro_torch is not beside this script")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_long_ab: torch.cuda.is_available() is false")

    from repro_torch import serve
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.memory import offload as mem_offload
    from repro_torch.models import model as Mdl
    from repro_torch.pipeline import PipelineExecutor

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = serve.config_for(ARCH, layers=LAYERS, attn_impl="flash")
    params = Mdl.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, DataConfig(batch=M, seq_len=SEQ), 0).items()}
    samples, live = [], weakref.WeakSet()

    class Box(mem_offload.Box):
        def hooks(self):
            @contextlib.contextmanager
            def filled():
                with super(Box, self).hooks():
                    yield
                live.add(self)
                samples.append((torch.cuda.memory_allocated(),
                                sum(b.nbytes() for b in live)))
            return filled()

    gib = 2.0 ** 30
    arms = {c: PipelineExecutor(cfg, ScheduleSpec("1f1b", P, M, seq_chunks=c),
                                remat="flash") for c in sorted(set(ORDER))}
    fits = {c: True for c in arms}

    def run(c):
        """One step of arm c, or None when it does not fit on the card."""
        samples.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            res = arms[c].step(params, batch)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            fits[c] = False
            print(f"  c {c}: does not fit on the card ({str(e).splitlines()[0]})")
            return None
        out = (s, max(samples), max(b for _, b in samples),
               torch.cuda.max_memory_allocated(),
               torch.cuda.max_memory_reserved(),
               [res.stats.peak_local[i] for i in range(P)], float(res.loss))
        del res
        return out

    plain_box, mem_offload.Box = mem_offload.Box, Box
    try:
        for c in arms:
            run(c)
        print(f"{cfg.name} {cfg.num_layers} layers d{cfg.d_model}, 1f1b p{P} m{M} x 1 "
              f"x {SEQ}, one step each in turns c {', '.join(map(str, ORDER))}:")
        for c in ORDER:
            if not fits[c]:
                continue
            r = run(c)
            if r is None:
                continue
            s, (at_peak, stash_then), stash_peak, peak, reserved, peaks, loss = r
            print(f"  c {c}: {1e3 * s:9.2f} ms, {M * SEQ / s:.1f} tokens/s; as a unit's "
                  f"forward ends, allocated at most {at_peak / gib:.2f} GiB (live boxes "
                  f"{stash_then / gib:.2f} GiB then), live boxes at most "
                  f"{stash_peak / gib:.2f} GiB; max_memory_allocated {peak / gib:.2f} GiB, "
                  f"reserved {reserved / gib:.2f} GiB; peak stash/stage {peaks}; loss "
                  f"{loss:.6f}")
    finally:
        mem_offload.Box = plain_box
    print(f"card {smi}")


if __name__ == "__main__":
    main()
