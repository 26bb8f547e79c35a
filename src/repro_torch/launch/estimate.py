"""The paper's section 4 workflow, end to end: decide whether BPipe is worth
implementing for a model *before* building it, from one cheap single-stage
measurement. The twin of the JAX package's
``examples/estimate_before_deploy.py``, with the same four steps and the
same printout:

  1. memory model: the largest micro batch b under 1F1B and under BPipe on
     an A100-80G (the paper's cluster, ``notation.A100_HBM_BYTES``);
  2. one pipeline stage measured at both b: ``planner.measure
     .measure_stage_gain`` (the port's executor, p = 1, m = 2, the second
     step traced) on a stage of ``--layers`` layers and ``--seq`` tokens
     (by default the 2048 that step 1 prices, 64 for ``--reduced``);
  3. eq. 4: the predicted whole-model speedup and the break-even stage gain
     (``estimator.required_stage_gain``);
  4. the verdict (with the BPipe traffic estimate).

    python -m repro_torch.launch.estimate --arch llama-65b --p 8 --t 4 \\
        --B 128 --layers 3                          # full width, on the card
    python -m repro_torch.launch.estimate --device cpu --reduced

The stage runs at full width in the config's dtype, unless ``--reduced``
takes the example's proxy: the config's reduced width in fp32. ``--attention``
picks the arm the memory model prices and the stage runs: flash runs the
flash kernels, recompute the reference attention recomputed in the backward
(``remat="attn"``), none the reference attention. The stage is t = 1 on one
device, where the paper's is l/p layers over t chips. Without ``--device
cpu`` it runs on the card and raises when there is none.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.core import estimator as E
from repro_torch.core import memory_model as MM
from repro_torch.core import notation as N
from repro_torch.core.flops import model_flops_train
from repro_torch.planner import measure

# attention arm -> (attn_impl, remat) of the measured stage
ARMS = {"none": ("reference", "none"), "recompute": ("reference", "attn"),
        "flash": ("flash", "none")}


def stage_config(cfg, attention: str, layers: int, reduced: bool):
    """The measured stage: ``layers`` layers of ``cfg`` in the arm's
    attention, at full width, or at the reduced width in fp32."""
    impl, _ = ARMS[attention]
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    return dataclasses.replace(cfg, num_layers=layers, attn_impl=impl)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen1.5-32b")
    ap.add_argument("--p", type=int, default=8)
    ap.add_argument("--t", type=int, default=4)
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--s", "--seq", dest="s", type=int, default=None,
                    help="the measured stage's seq len (default: 2048, the "
                         "memory model's; 64 with --reduced, the example's)")
    ap.add_argument("--attention", default="flash",
                    choices=["none", "recompute", "flash"])
    ap.add_argument("--layers", type=int, default=2,
                    help="layers of the measured stage")
    ap.add_argument("--reduced", action="store_true",
                    help="measure the reduced-width fp32 proxy stage")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns {"b_1f1b", "b_bpipe"} and, when BPipe unlocks a larger micro
    batch, "stage" (the measured config), "gain" (``measure_stage_gain``'s
    dict), "speedup" and "required"."""
    args = parse_args(argv)
    if args.s is None:
        args.s = 64 if args.reduced else 2048
    cfg = get_config(args.arch)
    n = N.from_model(cfg, b=1, s=2048, B=args.B, p=args.p, t=args.t)

    # 1. what does memory allow? (A100-80G per the paper's cluster)
    b_1f1b = MM.max_micro_batch(n, args.attention, "1f1b", N.A100_HBM_BYTES, cfg)
    b_bpipe = MM.max_micro_batch(n, args.attention, "bpipe", N.A100_HBM_BYTES, cfg)
    print(f"[memory] {args.arch} p={args.p} t={args.t} att={args.attention}: "
          f"max b under 1F1B={b_1f1b}, under BPipe={b_bpipe}")
    out = {"b_1f1b": b_1f1b, "b_bpipe": b_bpipe}
    if b_bpipe <= b_1f1b:
        print("[verdict] BPipe unlocks no larger micro-batch here -> skip it.")
        return out

    # 2. one stage measured at both micro-batch sizes
    stage = stage_config(cfg, args.attention, args.layers, args.reduced)
    gain = measure.measure_stage_gain(stage, b_bpipe, b_1f1b, seq=args.s,
                                      remat=ARMS[args.attention][1],
                                      device=args.device)
    t_x, t_y = gain["Tx"], gain["Ty"]
    fl = model_flops_train(stage, 1, args.s)
    mfu_y = b_1f1b * fl / t_y
    mfu_x = b_bpipe * fl / t_x  # relative units cancel in eq. 4
    print(f"[stage] T({b_1f1b})={t_y*1e3:.1f}ms T({b_bpipe})={t_x*1e3:.1f}ms "
          f"-> stage-MFU ratio {mfu_x/mfu_y:.3f}")

    # 3. eq. 4 + the break-even corollary
    nx = n.replace(b=b_bpipe)
    sp = E.speedup(nx, b_bpipe, b_1f1b, mfu_x, mfu_y)
    need = E.required_stage_gain(n, b_bpipe, b_1f1b)
    traffic = MM.eviction_bytes(nx, args.attention) / 2**30
    print(f"[eq.4] predicted whole-model speedup "
          f"(upper bound, BPipe overhead ignored): {sp:.3f}x")
    print(f"[break-even] stage-MFU gain required just to cover the larger "
          f"bubble: {need:.3f}x (measured {mfu_x/mfu_y:.3f}x)")
    print(f"[traffic] {traffic:.2f} GiB per evicted microbatch-stash; "
          f"1-hop on the pair-adjacent layout")

    # 4. verdict, with the paper's own caution
    if sp > 1.05:
        print("[verdict] >5% headroom -> BPipe likely worth implementing.")
    else:
        print("[verdict] headroom within BPipe's own overhead "
              "(the paper's LLaMA/flash case) -> NOT worth it.")
    out.update(stage=stage, gain=gain, speedup=sp, required=need)
    return out


if __name__ == "__main__":
    main()
