#!/usr/bin/env python3
"""Where the bf16 flash backward's gradients sit against a float64
evaluation, on one CUDA card.

    python3 chip_bf16_grad_rounding.py [--seed N ...]

The bf16 gradient checks (``chip_smoke.grad_agree``, the card tests'
``_assert_grad_close``) hold the kernels' dq, dk and dv to the plain
fp32 version, rounded to bf16 like them, within 2.5e-2 and within
1e-2 |want| + 1e-3 max |want|. At |grad| >= 4 one bf16 ulp exceeds
2.5e-2, so two fp32 sums on either side of a rounding boundary differ
there by more than the absolute bound. This script runs the backward on
``chip_smoke.SM90_SWEEP``'s cases (or, with ``--family``, on
``chip_smoke.FAMILY_ATTN``'s causal shapes that run the backward) with the
inputs the card tests draw (``tests/test_torch_gpu.py::_bwd_inputs`` for
each seed given, 5 and 6 by default: the dq and dk/dv tests' seeds),
evaluates the same gradients in float64 from the same bf16 inputs
(``chip_smoke.grads_float64``), and prints for each gradient the largest
|kernel - plain|, and for every element over 2.5e-2 the kernel's value,
the plain version's, the float64 value and how far that sits from the
nearest bf16 rounding boundary. It prints the card's name and power limit,
and exits non-zero without a card.

    python3 chip_bf16_grad_rounding.py --family --seed 0 1 2 3
"""
import argparse
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[5, 6])
    ap.add_argument("--family", action="store_true",
                    help="FAMILY_ATTN's backward shapes instead of SM90_SWEEP")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_bf16_grad_rounding: src/repro_torch is not beside this script")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_bf16_grad_rounding: torch.cuda.is_available() is false")
    from chip_smoke import FAMILY_ATTN, SM90_SWEEP, grads_float64
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cases = SM90_SWEEP
    if args.family:  # (b, sq, sk, nq, nkv, hd, window, softcap, q_offset)
        cases = [(b, s, s, nq, nkv, hd, w, cap, 0)
                 for b, s, nq, nkv, hd, w, cap, _, backward, _ in FAMILY_ATTN if backward]
    for seed in args.seed:
        for case in cases:
            b, sq, sk, nq, nkv, hd, window, softcap, q_offset = case
            gen = torch.Generator(dev).manual_seed(seed)  # as _bwd_inputs draws them
            q, k, v, do = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                           for shape in ((b, sq, nq, hd), (b, sk, nkv, hd),
                                         (b, sk, nkv, hd), (b, sq, nq, hd)))
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
            out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            exact = grads_float64(torch, q, k, v, do, lse,
                                  ref.flash_attention_delta(out, do, lse),
                                  scale=1.0 / math.sqrt(hd), **kw)
            for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
                g, w = g.double(), w.double()
                diff = (g - w).abs()
                print(f"[rounding] seed {seed} {case} {name}: max |kernel - plain| "
                      f"{float(diff.max()):.4g}; card {smi}")
                for idx in (diff > 2.5e-2).nonzero().tolist():
                    i = tuple(idx)
                    x = float(e[i])
                    ulp = 2.0 ** (math.floor(math.log2(abs(x))) - 7)
                    to_boundary = abs(abs(x) / ulp % 1 - 0.5) * ulp
                    print(f"[rounding]   at {idx}: kernel {float(g[i])}, plain "
                          f"{float(w[i])}, float64 {x:.9g} ({to_boundary:.3g} from "
                          f"a bf16 rounding boundary, ulp {ulp})")
            del q, k, v, do, out, lse, got, want, exact
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
