#!/usr/bin/env python3
"""What the bf16 hi + lo split of P^T and dS^T costs the sm90 dk/dv kernel,
on one CUDA card.

    python3 chip_dkv_split_ab.py

``csrc/flash_attention_dkv_sm90.cu`` feeds P^T and dS^T to dV += P^T dO and
dK += dS^T Q as bf16 hi + lo pairs, two wgmmas each, because one bf16
rounding breaks the gradient bound (``scripts/dkv_bf16_rounding.py``). This
script builds a copy of the kernel without the two lo wgmmas (so with one
rounding: out of bound, timed only) into the git-ignored build directory,
and times both on the same inputs with CUDA events at the training shape
(b 1 x 2048, 64 heads of 128, causal) and gpt3-96b's (104 heads of 96), in
the order split, single, single, split. It prints ptxas's report of the
copy and the card's name and power limit beside the numbers, and exits
non-zero without a card.
"""
import ctypes
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(1, 2048, 64, 128), (1, 2048, 104, 96)]  # b, s, heads, head_dim
LO_WGMMAS = ("wgmma_rs_n128_tb(dv, pl[kk], bdo, 1);", "wgmma_rs_n128_tb(dk, dl[kk], bq_, 1);",
             "wgmma_rs_n64_tb(dv, pl[kk], bdo, 1);", "wgmma_rs_n64_tb(dk, dl[kk], bq_, 1);")


def build_single(build):
    """The kernel without its lo wgmmas, as ``dkv_single`` in a library of
    its own; returns the bound C entry point."""
    src = (build.CSRC / "flash_attention_dkv_sm90.cu").read_text()
    for line in LO_WGMMAS:
        if line not in src:
            sys.exit(f"chip_dkv_split_ab: {line} is not in the kernel")
        src = src.replace(line, "")
    src = src.replace('extern "C" int flash_attention_dkv_sm90(', 'extern "C" int dkv_single(')
    out = build.BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    (out / "dkv_single.cu").write_text(src)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                          str(out / "dkv_single.so"), str(out / "dkv_single.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"chip_dkv_split_ab: nvcc failed:\n{res.stdout}{res.stderr}")
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas] single: {line.strip()}")
    return ctypes.CDLL(str(out / "dkv_single.so")).dkv_single


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        sys.exit("chip_dkv_split_ab: src/repro_torch is not beside this script")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_dkv_split_ab: torch.cuda.is_available() is false")
    from chip_smoke import time_ms
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    split = fa._lib("flash_attention_dkv_sm90", 8, 6, 12)
    single = build_single(build)
    single.argtypes, single.restype = split.argtypes, split.restype
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for b, s, nh, hd in SHAPES:
        q, k, v, do = (torch.randn((b, s, nh, hd), generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
        delta = ref.flash_attention_delta(out, do, lse)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, s, nh, nh, hd,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
                1, 0, 0, 0.0, 1 / math.sqrt(hd))

        def launch(fn):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
            if err:
                sys.exit(f"chip_dkv_split_ab: launch failed: cudaError {err}")

        for label, fn in (("split", split), ("single", single), ("single", single),
                          ("split", split)):
            ms = time_ms(torch, lambda: launch(fn), 20)
            print(f"[ab] dk/dv b{b} s{s} {nh}x{hd} bf16 causal, P^T and dS^T "
                  f"{label}: {ms:.4f} ms (CUDA events, 20 launches); card {smi}")
        del q, k, v, do, out, lse, delta, dk, dv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
