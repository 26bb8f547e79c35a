"""How precisely must the bf16 dk/dv kernel feed P^T and dS^T to its
second products? A CPU emulation, one kv head at a time.

    PYTHONPATH=src python scripts/dkv_bf16_rounding.py [--full]

The sm90 dk/dv kernel (``csrc/flash_attention_dkv_sm90.cu``) computes
dV = P^T dO and dK = dS^T Q on the tensor cores, with P^T and dS^T taken
from fp32 accumulator registers into bf16 A fragments. This script
emulates both ways of doing that on bf16 inputs, in fp32 arithmetic:

  * "split": each value as a bf16 hi + lo pair (about 16 bits), two
    products summed in fp32, as the forward and dq kernels do;
  * "single": one bf16 rounding of each value (8 bits), one product;

and holds each emulated dK and dV, rounded to bf16 as the kernel stores
them, to the bound ``chip_smoke.py`` and the card tests hold the kernel to:
every element within 1e-2 |want| + 1e-3 max |want| of the plain version
(``ref.flash_attention_bwd_ref``), and 2.5e-2 overall. It prints, for each
case, arm and gradient, the worst ratio of error to bound (at most 1
passes) and the count of elements over it.

The cases are ``chip_smoke.py``'s ``SM90_SWEEP``; ``--full`` adds its two
full-size backward cases (b 1 x 2048: 64 heads of 128, and 104 heads of
96), which take far longer. Inputs are standard normal from a seed,
as on the card; only torch on the CPU is used.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import G_ATOL, G_RTOL, SM90_SWEEP  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

# chip_smoke.py's two full-size bf16 backward cases, in SM90_SWEEP's order
FULL = [
    (1, 2048, 2048, 64, 64, 128, 0, 0.0, 0),
    (1, 2048, 2048, 104, 104, 96, 0, 0.0, 0),
]


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _feed(t, arm):
    """t as the kernel hands it to a product: one bf16 rounding, or the
    fp32 sum of a bf16 hi and the bf16 rounding of what hi leaves out."""
    hi = _bf16(t)
    return hi if arm == "single" else hi + _bf16(t - hi)


def emulate(q, k, v, dout, lse, delta, arm, **kw):
    """dK and dV (bf16) with P^T and dS^T fed to their products as ``arm``
    says, everything else in fp32; the same P and dS as the plain version."""
    qr, dor, p, ds = ref._p_ds(q, k, v, lse, delta, dout, **kw)
    dk = torch.einsum("bgmqk,bqgmh->bkgh", _feed(ds, arm), qr)
    dv = torch.einsum("bgmqk,bqgmh->bkgh", _feed(p, arm), dor)
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


def ratio(got, want):
    """(worst error / bound, elements over the bound) of one gradient."""
    g, w = got.float(), want.float()
    bound = G_RTOL * w.abs() + G_ATOL * w.abs().max()
    err = (g - w).abs()
    worst = max(float((err / bound).max()), float(err.max()) / 2.5e-2)
    return worst, int((err > bound).sum())


def run_case(case, gen):
    b, sq, sk, nq, nkv, hd, window, softcap, q_offset = case
    m = nq // nkv
    kw = dict(causal=True, window=window, softcap=softcap,
              scale=1.0 / math.sqrt(hd), q_offset=q_offset)
    worst = {}
    for g in range(nkv):  # one kv head (and its m query heads) at a time
        q = torch.randn((b, sq, m, hd), generator=gen).to(torch.bfloat16)
        k = torch.randn((b, sk, 1, hd), generator=gen).to(torch.bfloat16)
        v = torch.randn((b, sk, 1, hd), generator=gen).to(torch.bfloat16)
        do = torch.randn((b, sq, m, hd), generator=gen).to(torch.bfloat16)
        out, lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        delta = ref.flash_attention_delta(out, do, lse)
        want = ref.flash_attention_dkv_ref(q, k, v, lse, delta, do, **kw)
        for arm in ("split", "single"):
            got = emulate(q, k, v, do, lse, delta, arm, **kw)
            for name, a, w in zip(("dk", "dv"), got, want):
                r, n = ratio(a, w)
                # the bound scales with max|want| over the whole tensor, so
                # a head's ratio is an upper bound on the tensor's
                prev = worst.get((arm, name), (0.0, 0))
                worst[arm, name] = (max(prev[0], r), prev[1] + n)
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="add the two full-size cases (far slower)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    gen = torch.Generator().manual_seed(args.seed)
    cases = SM90_SWEEP + (FULL if args.full else [])
    held = {("split", "dk"): True, ("split", "dv"): True,
            ("single", "dk"): True, ("single", "dv"): True}
    for case in cases:
        worst = run_case(case, gen)
        print(f"{case}: " + ", ".join(
            f"{arm} {name} {r:.3f} ({n} over)" for (arm, name), (r, n) in worst.items()))
        for key, (r, n) in worst.items():
            held[key] = held[key] and n == 0 and r <= 1.0
    print("holds on every case: " + ", ".join(
        f"{arm} {name} {ok}" for (arm, name), ok in held.items()))


if __name__ == "__main__":
    main()
