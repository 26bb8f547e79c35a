"""The largest allocations of one production dry-run step, by the port's
source line that made them: what sets a combo's ``temp_bytes``.

    PYTHONPATH=src python scripts/dryrun_allocations.py ARCH SHAPE MESH \
        [--variant V] [--seq S --batch B] [--min-gib 1.0] [--top 25]

Runs ``repro_torch.launch.dryrun.run_one`` for the combo (``--seq`` /
``--batch`` cut the input shape) and, in its measured run, sums the output
bytes of every local op that is not a view and allocates at least
``--min-gib`` GiB, keyed by the op, the output's shape and dtype and the
last three frames of ``repro_torch`` that issued it (the backward's ops
show ``train/steps.py``, where autograd runs). Host only, no card.
"""
import argparse
import collections
import json
import tempfile
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class Allocations(TorchDispatchMode):
    """Output bytes of the local ops at or over ``min_bytes``, by key."""

    def __init__(self, min_bytes):
        super().__init__()
        self.min_bytes = min_bytes
        self.bytes = collections.Counter()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(o, torch.Tensor)]
        n = sum(o.numel() * o.element_size() for o in outs)
        if outs and not func.is_view and n >= self.min_bytes:
            frames = [f for f in traceback.extract_stack()
                      if "repro_torch" in f.filename
                      and "launch/dryrun" not in f.filename]
            where = " <- ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno}"
                                for f in frames[-3:][::-1])
            key = (str(func), tuple(outs[0].shape), str(outs[0].dtype), where)
            self.bytes[key] += n
            self.count[key] += 1
        return out


def main():
    from repro_torch import configs
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser()
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=["single", "multi"])
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--seq", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--min-gib", type=float, default=1.0)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    if args.seq or args.batch:
        old = configs.INPUT_SHAPES[args.shape]
        configs.INPUT_SHAPES[args.shape] = configs.InputShape(
            args.shape, args.seq or old.seq_len, args.batch or old.global_batch,
            old.kind)
    seen = Allocations(args.min_gib * 2**30)
    measure = dryrun.measure

    def watched(fn, fn_args, arguments):
        got = measure(fn, fn_args, arguments)  # warm-up and measured run
        with seen:
            fn(*fn_args)  # once more, the caches warm, watched
        return got

    dryrun.measure = watched
    with tempfile.TemporaryDirectory() as out:
        path = dryrun.run_one(args.arch, args.shape, args.mesh,
                              with_roofline=False, out_dir=out, force=True,
                              variant=args.variant)
        with open(path) as f:
            mem = json.load(f)["full"]["memory"]
    print(f"temp_bytes {mem['temp_bytes']:,} ({mem['temp_bytes'] / 2**30:.2f} GiB)")
    for key, n in seen.bytes.most_common(args.top):
        op, shape, dtype, where = key
        print(f"{n / 2**30:9.2f} GiB x{seen.count[key]:4d} {op} {shape} "
              f"{dtype} {where}")


if __name__ == "__main__":
    main()
