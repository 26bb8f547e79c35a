#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; the kernels built from csrc/ (nvcc,
     all sources at once) with their ptxas report, and the count of HGMMA
     and UTMALDG instructions in each sm90 library (``cuobjdump -sass``);
  2. every kernel against its plain PyTorch version on the card, at the
     kernel tests' shapes and tolerances, at the bf16 route's own cases
     (``SM90_SWEEP``) and at the main paths' shapes: the flash forward (two
     runs bit-equal), and the backward's dq and dk/dv kernels (two runs
     bit-equal); each check prints its route (``sm90`` for bf16, ``fma``
     for fp32) and the C entry points it took;
  3. the kernels timed at the main paths' shapes beside their plain
     versions (one each: the forward, the dq pass, the dk/dv pass), one
     PyTorch library call as a yardstick, and the card's bound; the whole
     backward (D, dq and dk/dv) beside SDPA's;
  4. the serving path: ``repro_torch.serve`` on llama-65b at full width, 10
     layers (one stage of the paper's 8-way split of 80), batch 4, prompt
     2048, 16 generated tokens, flash attention, bf16 compute; with the
     launch counts of all three kernels read over that run (the backward
     kernels must not launch);
  5. the serve path's output checked: finite, in range, deterministic, and
     at a small fp32 size the flash arm equal to the reference arm; one
     prefill and its decode steps profiled (device busy share, top kernels);
  6. the training path: ``repro_torch.launch.train`` on llama-65b at full
     width, 4 layers, batch 1 x 2048, 5 steps, flash attention, bf16
     compute, fp32 params and Adam moments: step time, tokens/s, MFU, peak
     memory, each step's loss and grad norm, the launch counts over that
     run; one step profiled;
  7. the training path's output checked at a small fp32 size: the flash arm's
     loss and grads equal the reference arm's, the recompute arms equal no
     recompute, and one train step on the card equals the same step on the
     CPU;
  8. the fused scale-mask-softmax kernels (forward and backward) against
     their plain versions at the kernel tests' shapes and tolerances, at
     row lengths that reach every instance of the forward (``FS_ROWS``: a
     warp a row in registers up to 4096 columns, 16-byte or scalar
     accesses, the online block kernel past that; two forward runs
     bit-equal) and at the paper's GPT-3 score shape (b 2 x 104 heads x
     2048 x 2048, bf16, causal, scale 1/sqrt(96)); there
     ``ops.fused_softmax`` forward and
     backward once (the op's path, counted), then both kernels timed beside
     their plain versions, the unfused chain (time and CUDA kernel count)
     and the bound;
  9. the pipelined step: ``PipelineExecutor.step`` on llama-65b at full
     width, 4 layers, p = 4 (one layer per stage), m = 4 microbatches of
     1 x 2048, flash, bf16 compute, fp32 params, 3 steps under 1f1b and
     under bpipe: step ms, tokens/s, peak stash per stage, swaps, peak
     memory, each unit's real saved bytes beside the modelled unit bytes;
     checks the peaks, the swaps, 1f1b == bpipe (loss and per-leaf grad
     norms), the loss against ``loss_fn`` and the flash launch counts;
 10. the pipelined path at a small fp32 size: every arm of
     ``repro_torch.launch.pipeline`` (with Adam) on the card against the
     same arms on the CPU, and a host_offload unit's box off the card
     between OFFLOAD and FETCH (remat none and attn) with
     ``memory_allocated`` falling by its bytes;
 11. the paper's estimation path (``planner.measure``): a pinned D2H copy
     rate beside the PCIe figure of ``core/h100.py``; ``launch.estimate``
     on three arms at full width, seq 2048, m 2 (``GAIN``: llama-65b flash
     b 2 -> 4, gpt3-96b recompute and flash b 1 -> 2), each measured
     three times, its median gain beside ``required_stage_gain`` and the
     paper's A100 gain; ``audit`` of the pipelined step (``AUDIT``, 1f1b
     and bpipe: time scale, op skews, order divergence, each unit's real
     saved bytes beside the memory model's); ``launch.pipeline --plan
     auto`` at full width (``AUTO``); each path's flash launch counts.
It prints a JSON line of the kernels' numbers, then, last, the ok line. It
exits non-zero, printing no result, without a card or without the repo.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# b, s, nq, nkv, hd, dtype, window, softcap: tests/test_kernels.py's sweep
SWEEP = [
    (2, 64, 4, 2, 32, "float32", 0, 0.0),
    (2, 64, 4, 1, 32, "float32", 16, 0.0),
    (1, 96, 8, 8, 16, "float32", 0, 20.0),
    (2, 64, 4, 2, 32, "bfloat16", 0, 0.0),
    (1, 40, 2, 2, 64, "float32", 0, 0.0),
    (1, 128, 16, 4, 8, "float32", 32, 50.0),
    (3, 32, 2, 2, 128, "bfloat16", 8, 0.0),
]
# the four backward cases of tests/test_kernels.py:53-58 (b 1, fp32)
BWD_SWEEP = [
    (1, 32, 4, 2, 16, "float32", 0, 0.0),
    (1, 64, 4, 1, 32, "float32", 16, 0.0),
    (1, 48, 8, 8, 16, "float32", 0, 20.0),
    (1, 40, 2, 2, 32, "float32", 0, 0.0),
]
# the bf16 (sm90) route's own cases, b, sq, sk, nq, nkv, hd, window,
# softcap, q_offset: tiles cut by sq and sk (200; 24 queries over 56 keys at
# q_offset 32), GQA m 1, 2, 3, 4, 8, head_dim 8 to 128, window and softcap
SM90_SWEEP = [
    (2, 200, 200, 8, 8, 64, 0, 0.0, 0),
    (2, 24, 56, 8, 4, 32, 20, 0.0, 32),
    (1, 200, 200, 16, 4, 24, 0, 30.0, 0),
    (2, 24, 56, 16, 2, 128, 0, 0.0, 32),
    (1, 200, 200, 8, 1, 8, 50, 0.0, 0),
    (1, 300, 300, 6, 2, 96, 0, 0.0, 0),
    (1, 256, 256, 32, 4, 128, 64, 30.0, 0),
    (1, 130, 130, 4, 4, 96, 0, 20.0, 0),
]
MAIN = dict(arch="llama-65b", layers=10, batch=4, prompt=2048, gen=16)
# the fused softmax sweep of tests/test_kernels.py:94-99 (shape, dtype,
# scale, causal) plus one fp32 case past the kernels' 512-column switch; and
# the paper's section 3.2 score shape of gpt3-96b
FS_SWEEP = [
    ((4, 64, 64), "float32", 1.0, False),
    ((2, 4, 32, 32), "bfloat16", 0.125, True),
    ((1, 8, 48, 48), "float32", 0.07, True),
    ((96, 128), "float32", 2.0, False),
    ((2, 3, 700, 700), "float32", 0.1, True),   # rows wider than 512: a block a row
]
# row lengths that reach each instance of the forward: unaligned for
# 16-byte accesses (1, 7, 513), aligned (200, 512, 2048, 4096), and past
# the widest row a warp keeps in registers (8192: the online block kernel);
# causal scores are square, the others a few rows
FS_ROWS = [((((2, sk, sk) if sk <= 513 else (sk, sk)) if causal else (2, 33, sk)),
            dtype, 0.3, causal)
           for sk in (1, 7, 200, 512, 513, 2048, 4096, 8192)
           for causal in (False, True) for dtype in ("float32", "bfloat16")]
FS_MAIN = ((2, 104, 2048, 2048), "bfloat16", 1.0 / math.sqrt(96), True)
PIPE = dict(arch="llama-65b", layers=4, p=4, micro=1, m=4, seq=2048, steps=3)
TRAIN = dict(arch="llama-65b", layers=4, batch=1, seq=2048, steps=5)
# the stage-gain arms, each run through ``launch.estimate`` at GAIN_SEQ
# tokens: (arch, attention arm, stage layers, the memory model's b pair bx,
# by). The depth is the deepest whose peak stayed under 70 GiB on the card:
# measured peaks 60.36, 41.14 and 61.81 GiB at these depths (PERF.md). Each
# arm is measured GAIN_RUNS times; its verdict is read from the median gain.
GAIN = [("llama-65b", "flash", 3, 4, 2),
        ("gpt3-96b", "recompute", 1, 2, 1),
        ("gpt3-96b", "flash", 2, 2, 1)]
GAIN_SEQ, GAIN_M, GAIN_RUNS = 2048, 2, 3      # GAIN_M: measure_stage_gain's m
AUDIT = dict(arch="llama-65b", layers=4, p=4, micro=1, m=4, seq=2048)
# --plan auto trains with Adam: at PIPE's depth its moments (28 GiB) and the
# launcher's copy of the params do not fit beside the stash, so 2 layers, p 2
AUTO = dict(arch="llama-65b", layers=2, stages=2, batch=4, seq=2048, steps=2)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def tol(dtype):
    return 2.5e-2 if dtype == "bfloat16" else 3e-5


# The plain version computes in fp32 from the bf16 inputs. The bf16 kernel
# (sm90 route) runs its products on the tensor cores: S = Q K^T from the
# bf16 inputs into fp32, and P V with P split into a bf16 hi + lo pair
# (about 16 bits of P), so beside one bf16 rounding of O (at most 2**-7 of
# |O|) and fp32 rounding of the LSE the two differ by about 2**-17 of each
# P V term. Beside the tests' 2.5e-2 every bf16 O element is held to
# O_ATOL + O_RTOL * |O| and the LSE to LSE_TOL: a wrong P V sum in a few
# rows cannot hide under the wide bound, and one bf16 rounding of P (2**-9
# of each term) would break it on rows with few keys.
O_RTOL, O_ATOL, LSE_TOL = 1e-2, 1e-4, 1e-4


def agree(torch, out, want_out, lse, want_lse, dtype):
    """(O error, LSE error, ok) of the kernel against its plain version."""
    o, w = out.float(), want_out.float()
    o_err = float((o - w).abs().max())
    lse_err = float((lse - want_lse).abs().max())
    ok = (bool(torch.isfinite(out).all()) and bool(torch.isfinite(lse).all())
          and o_err <= tol(dtype) and lse_err <= tol(dtype))
    if dtype == "bfloat16":
        ok = (ok and lse_err <= LSE_TOL
              and bool(((o - w).abs() <= O_ATOL + O_RTOL * w.abs()).all()))
    return o_err, lse_err, ok


# dq, dk, dv: fp32 as the JAX backward test (2e-4 / 1e-3). In bf16 the sums
# run over up to 2048 keys or queries before one bf16 rounding (dq's dS
# enters its product as a bf16 hi + lo pair), so beside the tests' 2.5e-2
# each element is held to G_RTOL |want| + G_ATOL max|want|.
G_ATOL32, G_RTOL32 = 2e-4, 1e-3
G_RTOL, G_ATOL = 1e-2, 1e-3


def grad_agree(torch, got, want, dtype):
    """(max abs error, ok) of one gradient against its plain version."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.isfinite(got).all())
    if dtype == "bfloat16":
        ok = (ok and float(err.max()) <= 2.5e-2
              and bool((err <= G_RTOL * w.abs() + G_ATOL * w.abs().max()).all()))
    else:
        ok = ok and bool((err <= G_ATOL32 + G_RTOL32 * w.abs()).all())
    return float(err.max()), ok


# Fused softmax: the tests' tolerances (y 1e-6 fp32 / 2e-2 bf16, rows sum to
# 1 within 2e-2; dx 1e-5 + 1e-4|want| fp32 / 2e-2 bf16). y is about
# 1/(row+1) at long causal rows, under 2e-2 almost everywhere, so every bf16
# element of y is also held to O_ATOL + O_RTOL|want| (one bf16 rounding is
# 2**-8 of |y|), and every bf16 element of dx to FS_DX_RTOL|want| plus
# FS_DX_ATOL times the mean |want| (a typical |dx|, not the largest).
FS_DX_RTOL, FS_DX_ATOL = 1e-2, 1e-3


def fs_agree(torch, y, want, dx, want_dx, dtype):
    """(y error, row-sum error, dx error, ok) of both fused softmax kernels
    against their plain versions."""
    o, w = y.float(), want.float()
    g, wg = dx.float(), want_dx.float()
    y_err = float((o - w).abs().max())
    row_err = float((o.sum(-1) - 1).abs().max())
    dx_err = float((g - wg).abs().max())
    ok = (bool(torch.isfinite(y).all()) and bool(torch.isfinite(dx).all())
          and row_err <= 2e-2)
    if dtype == "bfloat16":
        ok = (ok and y_err <= 2e-2 and dx_err <= 2e-2
              and bool(((o - w).abs() <= O_ATOL + O_RTOL * w.abs()).all())
              and bool(((g - wg).abs() <= FS_DX_RTOL * wg.abs()
                        + FS_DX_ATOL * wg.abs().mean()).all()))
    else:
        ok = (ok and y_err <= 1e-6
              and bool(((g - wg).abs() <= 1e-5 + 1e-4 * wg.abs()).all()))
    return y_err, row_err, dx_err, ok


def time_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(q, k, v, out, lse, *, causal, window, q_offset=0):
    """Least time of one attention forward on an H100: the larger of the
    bytes it must move over HBM bandwidth and the FLOPs of the (query, key)
    pairs these masks keep (two products of hd MACs each) over the bf16
    peak. Returns (ms, "bytes" | "operations")."""
    from repro_torch.core.h100 import H100_HBM_BW, H100_PEAK_BF16
    b, sq, nq, hd = q.shape
    pairs = causal_pairs(sq, k.shape[1], causal=causal, window=window,
                         q_offset=q_offset)
    flops = 4.0 * b * nq * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse))
    t_ops, t_bytes = flops / H100_PEAK_BF16, nbytes / H100_HBM_BW
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def causal_pairs(sq, sk, *, causal, window, q_offset=0):
    """(query, key) pairs the masks keep."""
    pairs = 0
    for i in range(sq):
        hi = min(sk, i + q_offset + 1) if causal else sk
        lo = max(0, i + q_offset - window + 1) if window else 0
        pairs += max(0, hi - lo)
    return pairs


def bwd_bounds(q, k, v, lse, *, causal, window):
    """Least time of each backward kernel on an H100, as for the forward:
    dq does 3 products per kept (query, key) pair (S, dP, dS K), dk/dv 4
    (S, dP, P^T dO, dS^T Q), 2 hd FLOP each; each reads q, k, v, dO, LSE
    and D once and writes its outputs once. Returns {name: (ms, by)}."""
    from repro_torch.core.h100 import H100_HBM_BW, H100_PEAK_BF16
    b, sq, nq, hd = q.shape
    pair_flops = 2.0 * b * nq * hd * causal_pairs(
        sq, k.shape[1], causal=causal, window=window)
    el = q.element_size()
    read = (2 * q.numel() + k.numel() + v.numel()) * el + 2 * lse.numel() * 4
    out = {}
    for name, n_products, written in (("flash_attention_dq", 3, q.numel()),
                                      ("flash_attention_dkv", 4,
                                       k.numel() + v.numel())):
        t_ops = n_products * pair_flops / H100_PEAK_BF16
        t_bytes = (read + written * el) / H100_HBM_BW
        out[name] = (1e3 * max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def kernel_device_ms(torch, fn, names, iters=5):
    """Device time per launch of each kernel whose name holds one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for n in names:
            if n in e.key and e.self_device_time_total > 0:
                out[n] = e.self_device_time_total / 1e3 / e.count
    missing = [n for n in names if n not in out]
    if missing:
        fail(f"the profiler shows no device time for {missing}")
    return out


# kernel names -> the kinds a profile is summed by (first match wins)
PROFILE_KINDS = [
    ("port flash kernels", ("flash_fwd_sm90_kernel", "flash_fwd_fma_kernel",
                            "flash_dq_sm90_kernel", "flash_dq_fma_kernel",
                            "flash_dkv_sm90_kernel", "flash_dkv_fma_kernel")),
    ("port fused softmax kernels", ("fused_softmax_fwd_warp_kernel",
                                    "fused_softmax_fwd_online_kernel",
                                    "fused_softmax_bwd_kernel")),
    ("GEMMs", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("elementwise, copies and casts", ("elementwise", "copy", "fill", "cat")),
    ("reductions", ("reduce", "softmax", "norm")),
]


def profile_window(torch, label, fn, top=8):
    """Run ``fn`` under torch.profiler and print the device-time breakdown:
    the kernels' summed device time against the window's wall time (the
    device's busy share), and the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f} % "
              f"x{e.count:<5d} {e.key[:90]}")
    kinds = {}
    for e in kernels:
        kind = next((k for k, marks in PROFILE_KINDS if any(m in e.key for m in marks)),
                    "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total
    print(f"[profile] {label} by kind: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({100 * v / max(busy_us, 1):.1f} %)"
        for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))


def counts_zero(fa):
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import fused_softmax as fs
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0
    fs.fused_softmax_fwd.launches = 0
    fs.fused_softmax_bwd.launches = 0


def fs_counts_read():
    from repro_torch.kernels import fused_softmax as fs
    return {"fused_softmax_fwd": fs.fused_softmax_fwd.launches,
            "fused_softmax_bwd": fs.fused_softmax_bwd.launches}


def counts_read(fa):
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_bwd.dq_launches,
            "flash_attention_dkv": fa.flash_attention_bwd.dkv_launches}


def train_path(torch, dev, smi):
    """Phase 6: the launcher's training loop at full width; returns the
    kernel launch counts over that run."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.h100 import H100_PEAK_BF16
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.train.steps import make_train_step

    t = TRAIN
    argv = ["--arch", t["arch"], "--layers", str(t["layers"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--steps", str(t["steps"]),
            "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats()
    counts_zero(fa)
    res = launch_train.main(argv)
    counts = counts_read(fa)
    peak = torch.cuda.max_memory_allocated()
    cfg, steps = res["cfg"], res["steps"]
    for st in steps:
        print(f"[train] step {st['step']}: loss {st['loss']:.6f} grad_norm "
              f"{st['grad_norm']:.6f} lr {st['lr']:.3e} {st['s'] * 1e3:.2f} ms")
    step_s = sorted(st["s"] for st in steps[2:5])[1]
    tokens = t["batch"] * t["seq"]
    n = cfg.param_count()
    flops = (6 * n + 6 * cfg.num_layers * t["seq"] * cfg.d_model) * tokens
    mfu = flops / step_s / H100_PEAK_BF16
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[train] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
          f"attn={cfg.attn_impl}: b{t['batch']} x {t['seq']}, {t['steps']} steps; "
          f"step {step_s * 1e3:.2f} ms (median of steps 3-5), "
          f"{tokens / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"(= (6 N + 6 L s d) tokens / step time / 989e12, N {n}, L "
          f"{cfg.num_layers}, s {t['seq']}, d {cfg.d_model}, tokens {tokens}); "
          f"peak memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB; "
          f"card {smi}")
    print(f"[train] launches over the run: {counts}")
    want = cfg.num_layers * t["steps"]
    if any(v != want for v in counts.values()):
        fail(f"training launched {counts}, want {want} of each kernel")
    if not all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
               for st in steps):
        fail("a training loss or grad norm is not finite")
    if peak >= total:
        fail(f"peak memory {peak} is not under the card's {total}")

    # where the time goes: one step profiled
    params, opt = res["params"], res["opt"]
    tcfg = dataclasses.replace(TrainConfig(), steps=t["steps"], seq_len=t["seq"])
    step_fn = make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, DataConfig(batch=t["batch"], seq_len=t["seq"]), 0).items()}
    box = {"p": params, "o": opt}

    def one_step():
        box["p"], box["o"], _ = step_fn(box["p"], box["o"], batch)

    profile_window(torch, "train step", one_step, top=16)

    del res, params, opt, box, batch
    torch.cuda.empty_cache()
    return counts


def train_checks(torch, dev):
    """Phase 7: the training path at a small fp32 size on the card."""
    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    from repro_torch.train.steps import make_loss_grad, make_train_step

    def small_cfg(impl):
        return serve.config_for(TRAIN["arch"], layers=3, attn_impl=impl,
                                reduced=True)

    cfg = small_cfg("flash")
    params = M.init_params(torch.Generator(dev).manual_seed(4), cfg, dev)
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), generator=g)
    labels = toks[:, 1:].clone()
    labels[0, :5] = -1
    batch = {"tokens": toks[:, :-1].to(dev), "labels": labels.to(dev)}

    def close(got, want, atol, rtol):
        return max(float(((a - b).abs() - atol - rtol * b.abs()).max())
                   for a, b in zip(T.leaves(got), T.leaves(want))) <= 0

    def max_err(got, want):
        return max(float((a - b).abs().max())
                   for a, b in zip(T.leaves(got), T.leaves(want)))

    results = {}
    for impl in ("flash", "reference"):
        for remat in ("none", "attn", "full"):
            counts_zero(fa)
            loss, grads = make_loss_grad(small_cfg(impl), TrainConfig(remat=remat))(
                params, batch)
            results[impl, remat] = (float(loss), grads, fa.flash_attention_fwd.launches)
    f_loss, f_grads, _ = results["flash", "none"]
    r_loss, r_grads, _ = results["reference", "none"]
    ok = abs(f_loss - r_loss) <= 2e-4 and close(f_grads, r_grads, 2e-4, 1e-3)
    print(f"[check] reduced llama-65b fp32 training, flash vs reference arm: loss "
          f"{f_loss:.7f} vs {r_loss:.7f}, grads max_abs_err "
          f"{max_err(f_grads, r_grads):.3e} (tol 2e-4 + 1e-3|want|) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the flash arm's loss or grads disagree with the reference arm's")
    for impl in ("flash", "reference"):
        base_loss, base_grads, base_n = results[impl, "none"]
        for remat in ("attn", "full"):
            loss, grads, n = results[impl, remat]
            err = max(abs(loss - base_loss), max_err(grads, base_grads))
            ok = err <= 1e-6
            if impl == "flash" and remat == "attn":
                ok = ok and n == 2 * base_n == 2 * cfg.num_layers
            print(f"[check] {impl} remat={remat} vs none: max err {err:.3e} "
                  f"(tol 1e-6), forward kernel launches {n} (none: {base_n}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"remat={remat} changes the {impl} arm's loss or grads, "
                     f"or the forward kernel count")
    # one train step on the card against the CPU, each piece on the same
    # inputs: the loss (1e-5) and grads (2e-4 + 1e-3|want|) against the
    # CPU's, and the card's Adam update of its grads (the flash arm's above:
    # the kernels are deterministic, so the step takes the same) against the
    # CPU's Adam update of the same params and grads (1e-5 per-leaf relative
    # norm of the update). Adam divides each grad by its rms, so two correct
    # steps whose grads differ by rounding move small-grad elements apart by
    # up to 2 lr: params after the two whole steps are printed, not held.
    tcfg = TrainConfig(steps=10, warmup_steps=2, learning_rate=1e-3)
    step = make_train_step(cfg, tcfg)
    to_cpu = lambda tree: T.tree_map(lambda t: t.to("cpu", copy=True), tree)
    p0 = to_cpu(params)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    cpu_loss, cpu_grads = make_loss_grad(cfg, tcfg)(to_cpu(p0), cpu_batch)
    params, _, m = step(params, adam.init(params), batch)
    want, _, _ = adam.update(to_cpu(p0), to_cpu(f_grads), adam.init(p0), tcfg)
    cpu_step, _, _ = adam.update(to_cpu(p0), cpu_grads, adam.init(p0), tcfg)
    loss_err = abs(float(m["loss"]) - float(cpu_loss))
    upd = max(float(((a.cpu() - w0) - (b - w0)).norm() / (b - w0).norm())
              for a, b, w0 in zip(T.leaves(params), T.leaves(want), T.leaves(p0)))
    whole = max(float((a.cpu() - b).norm() / b.norm())
                for a, b in zip(T.leaves(params), T.leaves(cpu_step)))
    ok = (loss_err <= 1e-5 and upd <= 1e-5
          and close(to_cpu(f_grads), cpu_grads, 2e-4, 1e-3))
    print(f"[check] one train step on the card vs on the CPU: loss err "
          f"{loss_err:.3e} (tol 1e-5), grads max_abs_err "
          f"{max_err(to_cpu(f_grads), cpu_grads):.3e} (tol 2e-4 + 1e-3|want|), "
          f"Adam update of the same params and grads max per-leaf relative "
          f"norm err {upd:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}; params "
          f"after the two whole steps max per-leaf relative norm err {whole:.3e}")
    if not ok:
        fail("a train step on the card disagrees with the same step on the CPU")


def graph_nodes(torch, fn):
    """The nodes of one call of ``fn`` captured in a CUDA graph, by type:
    {"kernel": n, "memset": n, "memcpy": n, "other": n}. The GPU analogue of
    kernel_bench.fusion_count: capture records every launch, where the
    profiler's activity buffers can drop kernel records."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")

    def check(err):
        if err:
            fail(f"the CUDA driver refused a graph query: CUresult {err}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)))
    # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset
    out = {"kernel": 0, "memcpy": 0, "memset": 0, "other": 0}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)))
        out[{0: "kernel", 1: "memcpy", 2: "memset"}.get(kind.value, "other")] += 1
    del graph
    torch.cuda.synchronize()
    return out


def fused_softmax_phase(torch, dev, gen, smi):
    """Phase 8: both fused softmax kernels against their plain versions, the
    op's path at the section 3.2 shape, and the timings. Returns the rows'
    numbers by kernel name."""
    from repro_torch.core.h100 import H100_HBM_BW, H100_PEAK_FP32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_softmax as fs
    from repro_torch.kernels import ops, ref

    def inputs(shape, dtype):
        x = (torch.randn(shape, generator=gen, device=dev) * 4).to(getattr(torch, dtype))
        return x, torch.randn(shape, generator=gen, device=dev).to(x.dtype)

    err = {"fused_softmax_fwd": 0.0, "fused_softmax_bwd": 0.0}
    for shape, dtype, scale, causal in FS_SWEEP + FS_ROWS + [FS_MAIN]:
        x, dy = inputs(shape, dtype)
        y = fs.fused_softmax_fwd(x, scale=scale, causal=causal)
        same = torch.equal(y, fs.fused_softmax_fwd(x, scale=scale, causal=causal))
        dx = fs.fused_softmax_bwd(y, dy, scale=scale)
        torch.cuda.synchronize()
        want = ref.fused_softmax_ref(x, scale=scale, causal=causal)
        want_dx = ref.fused_softmax_bwd_ref(y, dy, scale=scale)
        y_err, row_err, dx_err, ok = fs_agree(torch, y, want, dx, want_dx, dtype)
        ok = ok and same
        print(f"[check] fused_softmax {tuple(shape)} {dtype} scale {scale:.4g} "
              f"causal {causal}: max_abs_err y {y_err:.3e} (rows sum to 1 within "
              f"{row_err:.3e}) dx {dx_err:.3e}; two forward runs bit-equal {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"a fused softmax kernel disagrees with its plain version at "
                 f"{shape} {dtype} causal {causal}, or two runs differ")
        err["fused_softmax_fwd"] = max(err["fused_softmax_fwd"], y_err)
        err["fused_softmax_bwd"] = max(err["fused_softmax_bwd"], dx_err)
        del x, dy, y, dx, want, want_dx
    torch.cuda.empty_cache()
    # the op's grads against autograd through the plain version
    # (tests/test_kernels.py:110-117: fp32, causal, scale 0.5, atol 1e-5 rtol 1e-4)
    x = torch.randn((2, 2, 16, 16), generator=gen, device=dev).requires_grad_(True)
    g1, = torch.autograd.grad((ops.fused_softmax(x, 0.5, True) ** 2).sum(), x)
    g2, = torch.autograd.grad(
        (ref.fused_softmax_ref(x, scale=0.5, causal=True) ** 2).sum(), x)
    ok = bool(((g1 - g2).abs() <= 1e-5 + 1e-4 * g2.abs()).all())
    # the unfused chain against the fused op (tests/test_kernels.py:120-127)
    xb = torch.randn((4, 32, 32), generator=gen, device=dev).to(torch.bfloat16)
    chain_err = float((ops.unfused_softmax_chain(xb, 0.3, True).float()
                       - ops.fused_softmax(xb, 0.3, True).float()).abs().max())
    ok = ok and chain_err <= 1e-2
    print(f"[check] ops.fused_softmax grad vs autograd of the plain version: "
          f"max_abs_err {float((g1 - g2).abs().max()):.3e} (tol 1e-5 + "
          f"1e-4|want|); unfused chain vs fused {chain_err:.3e} (tol 1e-2) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("ops.fused_softmax's grad or the unfused chain disagrees")

    # the op's path at the section 3.2 shape: one forward and its backward
    shape, dtype, scale, causal = FS_MAIN
    x, dy = inputs(shape, dtype)
    xg = x.detach().requires_grad_(True)
    counts_zero(fa)
    y = ops.fused_softmax(xg, scale, causal)
    dx, = torch.autograd.grad(y, xg, dy)
    torch.cuda.synchronize()
    launches = fs_counts_read()
    print(f"[fused_softmax] ops.fused_softmax forward + backward at "
          f"{tuple(shape)} {dtype} causal scale 1/sqrt(96): launches {launches}")
    if launches != {"fused_softmax_fwd": 1, "fused_softmax_bwd": 1}:
        fail(f"ops.fused_softmax launched {launches}, want one of each")
    del xg, dx
    y = y.detach()
    n = x.numel()
    # the forward needs x only where the causal mask keeps it (the kernel
    # loads no masked element): row r of each sk x sk block keeps r + 1
    kept = n * (shape[-1] + 1) // (2 * shape[-1]) if causal else n
    rows = {}
    for name, n_bytes, n_ops, kernel, plain, library in (
            ("fused_softmax_fwd", (kept + n) * x.element_size(), 6 * kept + n,
             lambda: fs.fused_softmax_fwd(x, scale=scale, causal=causal),
             lambda: ref.fused_softmax_ref(x, scale=scale, causal=causal), None),
            ("fused_softmax_bwd", 3 * n * x.element_size(), 5 * n,
             lambda: fs.fused_softmax_bwd(y, dy, scale=scale),
             lambda: ref.fused_softmax_bwd_ref(y, dy, scale=scale),
             lambda: torch._softmax_backward_data(dy, y, -1, y.dtype))):
        t_bytes, t_ops = n_bytes / H100_HBM_BW, n_ops / H100_PEAK_FP32
        rows[name] = dict(
            max_abs_err=err[name], launches=launches[name],
            ms=time_ms(torch, kernel, 10), plain_ms=time_ms(torch, plain, 3, warmup=1),
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if library is None else time_ms(torch, library, 10))
    chain = lambda: ops.unfused_softmax_chain(x, scale, causal)
    chain_ms = time_ms(torch, chain, 3, warmup=1)
    chain_nodes = graph_nodes(torch, chain)
    fused_nodes = graph_nodes(
        torch, lambda: fs.fused_softmax_fwd(x, scale=scale, causal=causal))
    chain_kernels, fused_kernels = chain_nodes["kernel"], fused_nodes["kernel"]
    if fused_kernels != launches["fused_softmax_fwd"]:
        fail(f"one fused forward captured as {fused_nodes}, want "
             f"{launches['fused_softmax_fwd']} kernel as its counter says")
    softmax_ms = time_ms(torch, lambda: torch.softmax(x, dim=-1), 10)
    rows["fused_softmax_fwd"].update(unfused_chain_ms=chain_ms,
                                     unfused_chain_kernels=chain_kernels,
                                     kernels=fused_kernels)
    for name, r in rows.items():
        lib = ("" if r["library_ms"] is None else
               f", torch._softmax_backward_data {r['library_ms']:.4f} ms (no scale)")
        print(f"[time] {name} {tuple(shape)} {dtype} causal: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms{lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); card {smi}")
    print(f"[time] unfused chain (upcast, scale, mask, softmax, downcast) "
          f"{chain_ms:.4f} ms in {chain_kernels} CUDA kernels (one call captured "
          f"in a CUDA graph: nodes {chain_nodes}), the fused forward in "
          f"{fused_kernels} (nodes {fused_nodes}; launch counter "
          f"{launches['fused_softmax_fwd']}); torch.softmax alone (bf16, no "
          f"scale or mask) {softmax_ms:.4f} ms; card {smi}")
    del x, dy, y
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def unit_bytes_recorded(real):
    """While open, every stash unit's box appends its saved bytes to
    ``real`` once its forward has filled it."""
    from repro_torch.memory import offload as mem_offload

    class Box(mem_offload.Box):
        def hooks(self):
            @contextlib.contextmanager
            def filled():
                with super(Box, self).hooks():
                    yield
                real.append(self.nbytes())
            return filled()

    plain_box, mem_offload.Box = mem_offload.Box, Box
    try:
        yield
    finally:
        mem_offload.Box = plain_box


def pipeline_path(torch, dev, smi):
    """Phase 9: the pipelined step at full width under 1f1b and bpipe.
    Returns the flash launch counts of each arm's executor steps."""
    import statistics

    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.core import memory_model as mm
    from repro_torch.core.notation import Notation
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor

    t = PIPE
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    bsz = t["m"] * t["micro"]
    dc = DataConfig(batch=bsz, seq_len=t["seq"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, dc, i).items()}
               for i in range(t["steps"])]
    n = Notation(a=cfg.num_heads, b=t["micro"], h=cfg.d_model, l=cfg.num_layers,
                 s=t["seq"], v=cfg.vocab_size, B=bsz, p=t["p"], t=1)
    modelled = mm.sliced_unit_bytes(n, "flash", 1, 1)
    real = []
    out = {}
    with unit_bytes_recorded(real):
        for kind in ("1f1b", "bpipe"):
            ex = PipelineExecutor(cfg, ScheduleSpec(kind, t["p"], t["m"]),
                                  micro_batch=t["micro"], remat="flash")
            real.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            counts_zero(fa)
            times, res = [], None
            for batch in batches:
                del res
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = ex.step(params, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            counts = counts_read(fa)
            peak = torch.cuda.max_memory_allocated()
            step_s = statistics.median(times)
            st = res.stats
            norms = [float(g.float().norm()) for g in T.leaves(res.grads)]
            out[kind] = dict(counts=counts, loss=float(res.loss), norms=norms,
                             stats=st, step_ms=1e3 * step_s, peak=peak)
            print(f"[pipeline] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
                  f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
                  f"attn={cfg.attn_impl} {kind} p{t['p']} m{t['m']} x "
                  f"{t['micro']} x {t['seq']}: steps "
                  f"{' / '.join(f'{1e3 * s:.2f}' for s in times)} ms, median "
                  f"{1e3 * step_s:.2f} ms, {bsz * t['seq'] / step_s:.1f} tokens/s; "
                  f"loss {res.loss.item():.6f}; peak stash/stage "
                  f"{[st.peak_local[i] for i in range(t['p'])]}, evictions "
                  f"{st.evictions} loads {st.loads}; max_memory_allocated "
                  f"{peak / 2**30:.2f} GiB; saved bytes per unit {min(real) / 2**30:.3f}"
                  f"-{max(real) / 2**30:.3f} GiB real vs {modelled / 2**30:.3f} GiB "
                  f"modelled (memory_model, flash arm); card {smi}")
            print(f"[pipeline] {kind} launches over its {t['steps']} steps: {counts}")
            if kind == "1f1b":  # where the time goes: one more step, profiled
                del res
                profile_window(torch, "pipelined step (1f1b)",
                               lambda: ex.step(params, batches[0]), top=12)
                res = None
            del res, ex
            torch.cuda.empty_cache()
    a, b = out["1f1b"], out["bpipe"]
    want = [min(t["p"] - i, t["m"]) for i in range(t["p"])]
    ok_peaks = [a["stats"].peak_local[i] for i in range(t["p"])] == want
    from repro_torch.core import schedule as S
    ok_bpipe = (max(b["stats"].peak_local.values()) <= S.bpipe_cap(t["p"])
                and b["stats"].evictions == b["stats"].loads > 0)
    same = a["loss"] == b["loss"] and a["norms"] == b["norms"]
    with torch.no_grad():
        ref_loss, _ = M.loss_fn(params, {k: v for k, v in batches[-1].items()}, cfg)
    ref_loss = float(ref_loss)
    # bf16 compute: loss_fn runs the 4 rows through one batched GEMM where the
    # pipeline runs each microbatch alone, so GEMM tiling and the bf16
    # rounding of activations differ; the loss is a mean over 8192 fp32 nlls
    loss_err = abs(b["loss"] - ref_loss)
    want_launches = t["layers"] * t["m"] * t["steps"]
    ok_launches = all(v == want_launches for arm in out.values()
                      for v in arm["counts"].values())
    ok = ok_peaks and ok_bpipe and same and loss_err <= 1e-2 and ok_launches
    print(f"[check] pipelined step: 1f1b peaks {want} {ok_peaks}; bpipe under "
          f"cap {S.bpipe_cap(t['p'])} with evictions == loads > 0 {ok_bpipe}; "
          f"1f1b and bpipe loss and per-leaf grad norms bit-equal {same}; last "
          f"loss {b['loss']:.6f} vs loss_fn {ref_loss:.6f} (err {loss_err:.3e}, "
          f"tol 1e-2); flash launches {want_launches} per kernel per arm "
          f"{ok_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the pipelined step's peaks, swaps, losses or launches are wrong")
    del params, batches
    torch.cuda.empty_cache()
    return out


def pipeline_checks(torch, dev):
    """Phase 10: every arm of the pipeline launcher on the card against the
    CPU at a small fp32 size, and a host_offload unit's box off the card."""
    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.launch import pipeline as launch_pipeline
    from repro_torch.memory import offload as mem_offload
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor

    # the launcher's arms, with Adam: each step's loss on the card equals the
    # CPU's within 1e-5 (the second step's loss reads the first update)
    argv = ["--steps", "2"]
    card = launch_pipeline.main(argv + ["--device", "cuda"])
    cpu = launch_pipeline.main(argv + ["--device", "cpu"])
    for label, r in card["arms"].items():
        c = cpu["arms"][label]
        loss_err = max(abs(x - y) for x, y in zip(r["losses"], c["losses"]))
        # Adam divides each grad by its running rms, so where an element's
        # grad is small the update takes up the grads' rounding: the params
        # after Adam are printed here, and each piece of a step is held
        # below on the same inputs on both sides
        rel, worst = max((float((a.cpu() - b).norm() / b.norm()), "/".join(map(str, path)))
                         for (path, a), b in zip(T.leaves_with_paths(r["params"]),
                                                 T.leaves(c["params"])))
        ok = loss_err <= 1e-5
        print(f"[check] pipeline {label} on the card vs the CPU, 2 steps with "
              f"Adam: loss err {loss_err:.3e} (tol 1e-5) {'ok' if ok else 'FAIL'}; "
              f"params after Adam max per-leaf relative norm err {rel:.3e} ({worst})")
        if not ok:
            fail(f"the pipelined arm {label} on the card disagrees with the CPU")
    # the launcher's loop again, one step at a time: from the CPU's params
    # and moments, the card's executor grads against the CPU's (the flash
    # arm's 2e-4 + 1e-3|want|, as the training check above), and the card's
    # Adam update of those inputs against the CPU's Adam update of the same
    # params, moments and card grads (slice 2's 1e-5 per-leaf relative norm,
    # on every leaf's update)
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adam
    cfg = card["cfg"]
    tcfg = TrainConfig(global_batch=8, steps=2, warmup_steps=1, learning_rate=1e-3)
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    to = lambda tree, d: T.tree_map(lambda t: t.to(d, copy=True), tree)
    to_opt = lambda o, d: adam.AdamState(o.step.to(d), to(o.m, d), to(o.v, d))
    for kind, res in launch_pipeline.arms(4, 8, 2):
        spec = ScheduleSpec(kind, 4, 8, v=2, residency=res)
        ex = PipelineExecutor(cfg, spec)
        p_cpu = to(params, "cpu")
        o_cpu = adam.init(p_cpu)
        for i in range(2):
            batch = {k: torch.from_numpy(v) for k, v in make_batch(
                cfg, DataConfig(batch=8, seq_len=32), i).items()}
            got = ex.step(to(p_cpu, dev), to(batch, dev))
            want = ex.step(p_cpu, batch)
            g_err = max(float((a.cpu() - b).abs().max())
                        for a, b in zip(T.leaves(got.grads), T.leaves(want.grads)))
            ok = abs(float(got.loss) - float(want.loss)) <= 1e-5 and all(
                bool(((a.cpu() - b).abs() <= 2e-4 + 1e-3 * b.abs()).all())
                for a, b in zip(T.leaves(got.grads), T.leaves(want.grads)))
            p_card, _, _ = adam.update(to(p_cpu, dev), got.grads,
                                       to_opt(o_cpu, dev), tcfg)
            p_ref, _, _ = adam.update(to(p_cpu, "cpu"), to(got.grads, "cpu"),
                                      to_opt(o_cpu, "cpu"), tcfg)
            upd, upd_leaf = max(
                (float(((a.cpu() - p0) - (b - p0)).norm() / (b - p0).norm()),
                 "/".join(map(str, path)))
                for (path, a), b, p0 in zip(T.leaves_with_paths(p_card),
                                            T.leaves(p_ref), T.leaves(p_cpu)))
            ok = ok and upd <= 1e-5
            print(f"[check] executor {kind}+{res} step {i} on the card vs the CPU: "
                  f"loss err {abs(float(got.loss) - float(want.loss)):.3e} (tol 1e-5), "
                  f"grads max_abs_err {g_err:.3e} (tol 2e-4 + 1e-3|want|), Adam "
                  f"update of the same inputs max per-leaf relative norm err "
                  f"{upd:.3e} ({upd_leaf}; tol 1e-5) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"the executor's {kind}+{res} step {i} on the card disagrees "
                     f"with the CPU")
            p_cpu, o_cpu, _ = adam.update(p_cpu, want.grads, o_cpu, tcfg)
        same = all(torch.equal(a, b) for a, b in zip(
            T.leaves(p_cpu), T.leaves(cpu["arms"][launch_pipeline.arm_label(spec)]["params"])))
        print(f"[check] executor {kind}+{res}: these two CPU steps give the "
              f"launcher's CPU params bit for bit {same} {'ok' if same else 'FAIL'}")
        if not same:
            fail(f"the executor loop is not the launcher's {kind}+{res} arm")
    del card, cpu, params, batch, p_cpu, o_cpu, p_card, p_ref, got, want

    # a host_offload unit's box between OFFLOAD and FETCH
    moves = []
    to_host, to_device = mem_offload.to_host, mem_offload.to_device

    def settled():
        torch.cuda.synchronize()
        torch.empty(1, device=dev)  # lets the allocator retire freed blocks
        return torch.cuda.memory_allocated()

    def host(stash):
        before, nbytes = settled(), stash.box.nbytes()
        n_storages = len(stash.box.storages)
        to_host(stash)
        fell = before - settled()
        moves.append(("offload", nbytes, fell, n_storages,
                      all(st.device.type == "cpu" for st in stash.box.storages)))
        return stash

    def device(stash):
        off = all(st.device.type == "cpu" for st in stash.box.storages)
        before = settled()
        to_device(stash)
        moves.append(("fetch", stash.box.nbytes(), settled() - before,
                      len(stash.box.storages), off))
        return stash

    cfg = serve.config_for(PIPE["arch"], layers=4, attn_impl="flash", reduced=True)
    params = M.init_params(torch.Generator(dev).manual_seed(6), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 33),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mem_offload.to_host, mem_offload.to_device = host, device
    try:
        for remat in ("none", "attn"):
            moves.clear()
            spec = ScheduleSpec("1f1b", 4, 4, residency="host_offload")
            res = PipelineExecutor(cfg, spec, micro_batch=1, remat=remat).step(params, batch)
            base = PipelineExecutor(cfg, ScheduleSpec("1f1b", 4, 4), micro_batch=1,
                                    remat=remat).step(params, batch)
            same = float(res.loss) == float(base.loss) and all(
                torch.equal(a, b) for a, b in zip(T.leaves(res.grads), T.leaves(base.grads)))
            # each storage's block is its bytes rounded up to 512
            ok = (same and len(moves) == 2 * res.stats.offloads > 0 and all(
                off and n > 0 and n <= fell <= n + 512 * k for _, n, fell, k, off in moves))
            print(f"[check] host_offload remat={remat}: {res.stats.offloads} units "
                  f"offloaded; (move, box bytes, memory_allocated change, storages, "
                  f"box off the card) {moves}; loss and grads equal to plain 1f1b "
                  f"{same} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a host_offload unit left tensors on the card (remat={remat})")
    finally:
        mem_offload.to_host, mem_offload.to_device = to_host, to_device


def d2h_rate(torch):
    """Pinned device-to-host copy rate in bytes/s: 1 GiB copies, 5 timed
    after one warm-up, by CUDA events."""
    n = 2**30
    x = torch.empty(n, dtype=torch.uint8, device="cuda")
    h = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    h.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        h.copy_(x, non_blocking=True)
    end.record()
    end.synchronize()
    return 5 * n / (start.elapsed_time(end) / 1e3)


def paper_gain(arch, arm, bx, by):
    """The paper's A100 stage gain MFU_stage(bx) / MFU_stage(by) (Table 5)."""
    from repro_torch.core import estimator as E
    mfu = {r.b: r.mfu_stage for r in E.PAPER_ROWS
           if r.model == arch and r.attention == arm}
    return mfu[bx] / mfu[by]


def stage_gain_phase(torch, dev, smi):
    """Phase 11a: ``launch.estimate`` on each ``GAIN`` arm at full width.
    Returns each arm's flash launch counts by path name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import estimate

    out = {}
    for arch, arm, layers, bx, by in GAIN:
        impl, remat = estimate.ARMS[arm]
        argv = ["--arch", arch, "--attention", arm, "--layers", str(layers),
                "--seq", str(GAIN_SEQ), "--device", str(dev)]
        paper = paper_gain(arch, arm, bx, by)
        label = f"stage gain {arch} {arm}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts_zero(fa)
        gains = []
        for run in range(1, GAIN_RUNS + 1):
            t0 = time.perf_counter()
            res = estimate.main(argv)
            wall = time.perf_counter() - t0
            if (res["b_bpipe"], res["b_1f1b"]) != (bx, by):
                fail(f"{label}: the memory model's b pair is "
                     f"{res['b_bpipe']}, {res['b_1f1b']}, not {bx}, {by}")
            r, cfg, need = res["gain"], res["stage"], res["required"]
            print(f"[estimate] {label} run {run}/{GAIN_RUNS}: {cfg.num_layers} layers "
                  f"d{cfg.d_model} {cfg.num_heads}x{cfg.head_dim} {cfg.dtype} "
                  f"attn={cfg.attn_impl} remat={remat}, p 1 (1f1b), m {GAIN_M} x seq "
                  f"{GAIN_SEQ}, b {by} -> {bx}: Tx (b {bx}) {r['Tx'] * 1e3:.3f} ms, "
                  f"Ty (b {by}) {r['Ty'] * 1e3:.3f} ms (median F + median B of the "
                  f"traced step); measured gain {r['gain']:.4f}; {wall:.1f} s")
            if not all(math.isfinite(r[k]) and r[k] > 0 for k in ("Tx", "Ty", "gain")):
                fail(f"{label}: times {r['Tx']}, {r['Ty']} are not finite and positive")
            gains.append(r["gain"])
            del res, r
        counts = counts_read(fa)
        peak = torch.cuda.max_memory_allocated()
        gains.sort()
        median, spread = gains[len(gains) // 2], gains[-1] - gains[0]
        verdict = "can" if median > need else "cannot"
        near = (f"; the margin {abs(median - need):.4f} to the bar is within the "
                f"spread {spread:.4f}, so this verdict is not settled"
                if abs(median - need) <= spread else "")
        print(f"[estimate] {label}: median gain {median:.4f} over {GAIN_RUNS} runs "
              f"(spread {gains[0]:.4f}-{gains[-1]:.4f}) against required_stage_gain "
              f"{need:.4f} (p 8, t 4, B 128); the paper's A100 gain {paper:.4f} "
              f"(Table 5); verdict: BPipe at b {bx} {verdict} win on this stage{near}. "
              f"The stage is {layers} layers at full width on one card (t = 1), the "
              f"paper's is l/p = 10 layers over t = 4 A100s; peak {peak / 2**30:.2f} "
              f"GiB; launches {counts}; card {smi}")
        want = 2 * GAIN_M * layers * 2 * GAIN_RUNS if impl == "flash" else 0
        if any(v != want for v in counts.values()):
            fail(f"{label}: launches {counts}, want {want} of each flash kernel")
        out[label] = counts
    return out


def audit_phase(torch, dev, smi):
    """Phase 11b: ``measure.audit`` of the pipelined step under 1f1b and
    bpipe. Returns each run's flash launch counts by path name."""
    from repro_torch import serve
    from repro_torch.core import memory_model as mm
    from repro_torch.core.notation import Notation
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.planner import measure

    t = AUDIT
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash")
    n = Notation(a=cfg.num_heads, b=t["micro"], h=cfg.d_model, l=cfg.num_layers,
                 s=t["seq"], v=cfg.vocab_size, B=t["m"] * t["micro"], p=t["p"], t=1)
    out = {}
    for kind in ("1f1b", "bpipe"):
        real = []
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        counts_zero(fa)
        with unit_bytes_recorded(real):
            rep = measure.audit(cfg, ScheduleSpec(kind, t["p"], t["m"]),
                                micro_batch=t["micro"], seq=t["seq"], device=dev)
        counts = counts_read(fa)
        skews = ", ".join(f"{s.op} {s.skew:.4f} (x{s.count})" for s in rep.op_skew)
        div = ", ".join(f"{i}: {d:.4f}" for i, d in sorted(rep.order_div.items()))
        print(f"[audit] {cfg.name} {cfg.num_layers} layers {kind} p{t['p']} m{t['m']} "
              f"x {t['micro']} x {t['seq']}: time_scale (real step / simulated step "
              f"under the fitted Tf, Tb) {rep.time_scale:.6g}; op skew {skews}; order_divergence by stage {{{div}}}; "
              f"instructions {rep.real_count} real / {rep.sim_count} simulated, "
              f"missing_in_real {rep.missing_in_real}, missing_in_sim "
              f"{rep.missing_in_sim}; card {smi}")
        print(f"[audit] {kind}: saved bytes per unit {min(real) / 2**30:.3f}-"
              f"{max(real) / 2**30:.3f} GiB real over {len(real)} units vs memory_model "
              f"{mm.sliced_unit_bytes(n, 'none', 1, 1) / 2**30:.3f} GiB (arm none, the "
              f"executor's accounting at remat none) and "
              f"{mm.sliced_unit_bytes(n, 'flash', 1, 1) / 2**30:.3f} GiB (arm flash, "
              f"the attention it runs); launches {counts}")
        want = 2 * t["m"] * t["layers"]
        ok = (not rep.missing_in_real and not rep.missing_in_sim
              and math.isfinite(rep.time_scale) and rep.time_scale > 0
              and all(v == want for v in counts.values()))
        if not ok:
            fail(f"audit {kind}: missing lists, time scale or launches {counts} "
                 f"(want {want}) are wrong")
        out[f"audit {kind}"] = counts
    return out


def plan_auto_phase(torch, dev, smi):
    """Phase 11c: ``launch.pipeline --plan auto`` at full width. Returns its
    flash launch counts by path name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import pipeline as launch_pipeline

    a = AUTO
    argv = ["--plan", "auto", "--arch", a["arch"], "--layers", str(a["layers"]),
            "--stages", str(a["stages"]), "--batch", str(a["batch"]), "--seq",
            str(a["seq"]), "--steps", str(a["steps"]), "--device", str(dev)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts_zero(fa)
    t0 = time.perf_counter()
    res = launch_pipeline.main(argv)
    wall = time.perf_counter() - t0
    counts = counts_read(fa)
    best = res["plan"]
    (label, arm), = res["arms"].items()
    costs, replayed = arm["costs"], arm["replayed"]
    m = a["batch"] // best.cand.b
    print(f"[plan auto] {a['arch']} {a['layers']} layers p{a['stages']} batch "
          f"{a['batch']} x {a['seq']}: recommended {label} b {best.cand.b} m {m} "
          f"(est {100 * best.mfu:.1f} % MFU on the planner's A100 costs); ran {a['steps']} "
          f"steps with Adam, losses {arm['losses']}; recalibrated from the traced "
          f"last step: Tf {costs.Tf * 1e3:.3f} ms, Tb {costs.Tb * 1e3:.3f} ms -> "
          f"simulated step {replayed.makespan * 1e3:.2f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {wall:.1f} s "
          f"(params drawn on the CPU); launches {counts}; card {smi}")
    want = a["steps"] * m * a["layers"]
    ok = (all(math.isfinite(x) for x in arm["losses"])
          and all(math.isfinite(v) and v > 0 for v in (costs.Tf, costs.Tb))
          and all(v == want for v in counts.values()))
    if not ok:
        fail(f"--plan auto: losses, Tf/Tb or launches {counts} (want {want}) "
             f"are wrong")
    return {"plan auto": counts}


def estimation_phase(torch, dev, smi):
    """Phase 11: the paper's estimation path on the card. Returns the flash
    launch counts of each of its paths."""
    from repro_torch.core.h100 import H100_PCIE_BW
    rate = d2h_rate(torch)
    print(f"[estimate] pinned D2H copy {rate / 1e9:.2f} GB/s (1 GiB copies, CUDA "
          f"events) beside the PCIe Gen5 x16 figure {H100_PCIE_BW / 1e9:.0f} GB/s a "
          f"direction (core/h100.py); card {smi}")
    counts = stage_gain_phase(torch, dev, smi)
    counts.update(audit_phase(torch, dev, smi))
    counts.update(plan_auto_phase(torch, dev, smi))
    return counts


def sass_counts(libs):
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in each sm90
    library, from ``cuobjdump -sass``; fails if either is 0. Returns
    {name: {"HGMMA": n, "UTMALDG": n}}, empty without cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("[sass] cuobjdump not found: no SASS counts")
        return {}
    out = {}
    for name in ("flash_attention_fwd_sm90", "flash_attention_dq_sm90",
                 "flash_attention_dkv_sm90"):
        text = subprocess.run([tool, "-sass", str(libs[name])], capture_output=True,
                              text=True, check=True).stdout
        out[name] = {op: len(re.findall(rf"\b{op}\b", text)) for op in ("HGMMA", "UTMALDG")}
        print(f"[sass] {name}: {out[name]} (cuobjdump -sass, all instances)")
        if not all(out[name].values()):
            fail(f"{name} has no wgmma or no TMA load in its SASS: {out[name]}")
    return out


def main():
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        fail("src/repro_torch is not beside this script")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from repro_torch import serve
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    # -- 1. card and build ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}; host {os.cpu_count()} CPUs, torch "
          f"CPU threads {torch.get_num_threads()}, CPU capability "
          f"{torch.backends.cpu.get_cpu_capability()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ["flash_attention_fwd_sm90", "flash_attention_dq_sm90",
               "flash_attention_dkv_sm90", "flash_attention_fwd", "flash_attention_dq",
               "flash_attention_dkv", "fused_softmax_fwd", "fused_softmax_bwd"]
    t0 = time.perf_counter()
    libs = build.build(kernels)
    print(f"[build] {len(kernels)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs.items():
        entry = name
        for line in log.splitlines():
            m = re.search(r"\d((?:flash|fused_softmax)_[a-z0-9_]+?_kernel)I(.*?)Ev", line)
            if m:  # the instance: its template arguments
                args = [{"f": "float", "13__nv_bfloat16": "bf16"}.get(a, n) for a, n in
                        re.findall(r"(Li(\d+)E|f|13__nv_bfloat16)", m.group(2))]
                entry = f"{m.group(1)}<{', '.join(args)}>"
            elif "registers" in line or "spill" in line:
                print(f"  {entry}: {line.strip()}")
    sass = sass_counts(libs)

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)

    def qkv(b, sq, sk, nq, nkv, hd, dtype, strided=False):
        dt = getattr(torch, dtype)
        if strided:  # q/k/v as views of one fused projection, as a qkv matmul gives
            qkv_ = torch.randn((b, sq, 3, nq, hd), generator=gen, device=dev).to(dt)
            return qkv_[:, :, 0], qkv_[:, :, 1, :nkv], qkv_[:, :, 2, :nkv]
        return (torch.randn((b, sq, nq, hd), generator=gen, device=dev).to(dt),
                torch.randn((b, sk, nkv, hd), generator=gen, device=dev).to(dt),
                torch.randn((b, sk, nkv, hd), generator=gen, device=dev).to(dt))

    # -- 2. kernel vs plain on the card -----------------------------------------
    cases = [dict(b=b, sq=s, sk=s, nq=nq, nkv=nkv, hd=hd, dtype=dt, window=w,
                  softcap=c, q_offset=0, name="sweep")
             for b, s, nq, nkv, hd, dt, w, c in SWEEP]
    for dt in ("float32", "bfloat16"):
        cases.append(dict(b=2, sq=24, sk=56, nq=4, nkv=2, hd=32, dtype=dt,
                          window=20, softcap=0.0, q_offset=32, name="q_offset"))
    for dt in ("float32", "bfloat16"):
        cases.append(dict(b=2, sq=200, sk=200, nq=8, nkv=8, hd=64, dtype=dt,
                          window=0, softcap=0.0, q_offset=0, name="strided",
                          strided=True))
    cases += [dict(b=b, sq=sq, sk=sk, nq=nq, nkv=nkv, hd=hd, dtype="bfloat16",
                   window=w, softcap=c, q_offset=off, name="sm90")
              for b, sq, sk, nq, nkv, hd, w, c, off in SM90_SWEEP]
    cases.append(dict(b=4, sq=2048, sk=2048, nq=64, nkv=64, hd=128,
                      dtype="bfloat16", window=0, softcap=0.0, q_offset=0,
                      name="llama-65b main path"))
    cases.append(dict(b=1, sq=2048, sk=2048, nq=104, nkv=104, hd=96,
                      dtype="bfloat16", window=0, softcap=0.0, q_offset=0,
                      name="gpt3-96b hd 96"))
    max_err = 0.0
    for c in cases:
        q, k, v = qkv(c["b"], c["sq"], c["sk"], c["nq"], c["nkv"], c["hd"],
                      c["dtype"], c.get("strided", False))
        kw = dict(causal=True, window=c["window"], softcap=c["softcap"],
                  q_offset=c["q_offset"], return_lse=True)
        out, lse = fa.flash_attention_fwd(q, k, v, **kw)
        again = fa.flash_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
        o_err, lse_err, ok = agree(torch, out, want_out, lse, want_lse,
                                   c["dtype"])
        ok = ok and same
        extra = (f"; O within {O_ATOL} + {O_RTOL}|O|, LSE within {LSE_TOL}"
                 if c["dtype"] == "bfloat16" else "")
        print(f"[check] flash_attention_fwd {c['name']} b{c['b']} sq{c['sq']} "
              f"sk{c['sk']} {c['nq']}/{c['nkv']}x{c['hd']} {c['dtype']} "
              f"w{c['window']} cap{c['softcap']} off{c['q_offset']} route "
              f"{fa.route(q.dtype)}: max_abs_err O {o_err:.3e} LSE {lse_err:.3e} "
              f"(tol {tol(c['dtype'])}{extra}); two runs bit-equal {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_fwd disagrees with its plain version: {c}")
        max_err = max(max_err, o_err, lse_err)
        del q, k, v, out, lse, again, want_out, want_lse
    torch.cuda.empty_cache()

    # the backward's dq and dk/dv kernels against the plain backward
    bwd_cases = [dict(b=b, sq=s, sk=s, nq=nq, nkv=nkv, hd=hd, dtype=dt,
                      window=w, softcap=c, q_offset=0, name="bwd sweep")
                 for b, s, nq, nkv, hd, dt, w, c in BWD_SWEEP]
    bwd_cases += [dict(c, name="fwd sweep") for c in cases if c["name"] == "sweep"]
    bwd_cases += [c for c in cases if c["name"] in ("q_offset", "strided", "sm90")]
    bwd_cases.append(dict(b=1, sq=2048, sk=2048, nq=64, nkv=64, hd=128,
                          dtype="bfloat16", window=0, softcap=0.0, q_offset=0,
                          name="llama-65b training shape"))
    bwd_cases.append(dict(b=1, sq=2048, sk=2048, nq=104, nkv=104, hd=96,
                          dtype="bfloat16", window=0, softcap=0.0, q_offset=0,
                          name="gpt3-96b hd 96"))
    bwd_err = {"flash_attention_dq": 0.0, "flash_attention_dkv": 0.0}
    for c in bwd_cases:
        q, k, v = qkv(c["b"], c["sq"], c["sk"], c["nq"], c["nkv"], c["hd"],
                      c["dtype"], c.get("strided", False))
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        if c.get("strided"):  # dO as an einsum's backward may hand it over
            do = do.transpose(1, 2).contiguous().transpose(1, 2)
        kw = dict(causal=True, window=c["window"], softcap=c["softcap"],
                  q_offset=c["q_offset"])
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        errs = [grad_agree(torch, g_, w_, c["dtype"]) for g_, w_ in zip(got, want)]
        ok = same and all(e[1] for e in errs)
        bound = (f"{G_RTOL}|want| + {G_ATOL} max|want| and 2.5e-2"
                 if c["dtype"] == "bfloat16" else f"{G_ATOL32} + {G_RTOL32}|want|")
        kind = fa.route(q.dtype)
        entries = ", ".join(fa._ENTRIES[k, kind] for k in ("dq", "dkv"))
        print(f"[check] flash_attention_bwd {c['name']} b{c['b']} sq{c['sq']} "
              f"sk{c['sk']} {c['nq']}/{c['nkv']}x{c['hd']} {c['dtype']} "
              f"w{c['window']} cap{c['softcap']} off{c['q_offset']} route "
              f"{kind} ({entries}): "
              f"max_abs_err dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} "
              f"dv {errs[2][0]:.3e} (within {bound}); two runs bit-equal "
              f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_bwd disagrees with its plain version: {c}")
        bwd_err["flash_attention_dq"] = max(bwd_err["flash_attention_dq"], errs[0][0])
        bwd_err["flash_attention_dkv"] = max(bwd_err["flash_attention_dkv"],
                                             errs[1][0], errs[2][0])
        del q, k, v, do, out, lse, got, again, want
    torch.cuda.empty_cache()

    # -- 3. timing at the main path's shape --------------------------------------
    b, s, nh, hd = MAIN["batch"], MAIN["prompt"], 64, 128
    q, k, v = qkv(b, s, s, nh, nh, hd, "bfloat16")
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    bound_ms, bound_by = attention_bound(q, k, v, out, lse, causal=True, window=0)
    kernel_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, causal=True), 10)
    plain_ms = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       3, warmup=1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    print(f"[time] flash_attention_fwd b{b} s{s} {nh}x{hd} bf16 causal: kernel "
          f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); card {smi}")
    del q, k, v, out, lse, qt, kt, vt
    torch.cuda.empty_cache()

    # the backward at the training path's shape
    b, s = TRAIN["batch"], TRAIN["seq"]
    q, k, v = qkv(b, s, s, nh, nh, hd, "bfloat16")
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    bounds = bwd_bounds(q, k, v, lse, causal=True, window=0)
    bwd = lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    split = kernel_device_ms(torch, bwd, ["flash_dq_sm90_kernel", "flash_dkv_sm90_kernel"])
    bwd_ms = time_ms(torch, bwd, 10)
    delta = ref.flash_attention_delta(out, do, lse)
    plain_by = {name: time_ms(torch, lambda f=f: f(q, k, v, lse, delta, do,
                                                   causal=True), 3, warmup=1)
                for name, f in (("flash_attention_dq", ref.flash_attention_dq_ref),
                                ("flash_attention_dkv", ref.flash_attention_dkv_ref))}
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    bwd_library_ms = time_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
    bwd_ms_by = {"flash_attention_dq": split["flash_dq_sm90_kernel"],
                 "flash_attention_dkv": split["flash_dkv_sm90_kernel"]}
    for name, ms in bwd_ms_by.items():
        print(f"[time] {name} b{b} s{s} {nh}x{hd} bf16 causal: kernel {ms:.4f} ms "
              f"(profiler device time per launch), plain {plain_by[name]:.4f} ms, "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]}); card {smi}")
    print(f"[time] flash_attention_bwd (D + dq + dk/dv kernels) {bwd_ms:.4f} ms, "
          f"sdpa backward (dq, dk, dv together) {bwd_library_ms:.4f} ms; card {smi}")
    del q, k, v, do, out, lse, delta, qt, kt, vt, ot
    torch.cuda.empty_cache()

    # -- 4. the main path ------------------------------------------------------------
    cfg = serve.config_for(MAIN["arch"], layers=MAIN["layers"], attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (MAIN["batch"], MAIN["prompt"]),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    counts_zero(fa)
    runs = [serve.serve(params, cfg, prompts, MAIN["gen"]) for _ in range(2)]
    serve_counts = counts_read(fa)
    launches = serve_counts["flash_attention_fwd"]
    prefill_calls = len(runs)
    warm, res = runs
    print(f"[serve] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
          f"attn={cfg.attn_impl}: b{MAIN['batch']} prompt {MAIN['prompt']} "
          f"gen {MAIN['gen']}; prefill {res['prefill_s'] * 1e3:.2f} ms "
          f"(first call {warm['prefill_s'] * 1e3:.2f} ms), decode "
          f"{res['decode_tok_s']:.2f} tok/s ({res['decode_s'] * 1e3:.2f} ms for "
          f"{MAIN['gen'] - 1} steps); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi}")
    print(f"[serve] launches over {prefill_calls} prefill calls: {serve_counts}")
    if launches != cfg.num_layers * prefill_calls:
        fail(f"flash kernel launched {launches} times, want "
             f"{cfg.num_layers} x {prefill_calls}")
    if serve_counts["flash_attention_dq"] or serve_counts["flash_attention_dkv"]:
        fail(f"serving launched a backward kernel: {serve_counts}")

    # -- 5. is the output right --------------------------------------------------------
    toks = res["tokens"]
    if tuple(toks.shape) != (MAIN["batch"], MAIN["gen"]):
        fail(f"tokens shape {tuple(toks.shape)}")
    if not (0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        fail("generated tokens out of the vocabulary")
    for key in ("prefill_logits", "last_logits"):
        if not bool(torch.isfinite(res[key]).all()):
            fail(f"{key} not finite")
    if not torch.equal(toks, warm["tokens"]):
        fail("two serve runs of the same prompts gave different tokens")
    # where the time goes: one prefill and its decode steps, profiled apart
    b, sp, n_gen = MAIN["batch"], MAIN["prompt"], MAIN["gen"]
    state = M.init_decode_state(cfg, b, sp + n_gen, dev)
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    box = {}
    with torch.inference_mode():
        def run_prefill():
            box["logits"], box["state"] = prefill_step(
                params, {"tokens": prompts}, state)

        def run_decode():
            tok = torch.argmax(box["logits"], dim=-1).to(torch.int32)
            for i in range(n_gen - 1):
                tok, _, box["state"] = serve_step(params, box["state"], tok, sp + i)

        profile_window(torch, "prefill", run_prefill)
        profile_window(torch, f"decode ({n_gen - 1} steps)", run_decode)
    del state, box
    del params, runs, warm, res
    torch.cuda.empty_cache()
    # flash arm == reference arm at a small fp32 size on the card
    small = {}
    for impl in ("flash", "reference"):
        scfg = serve.config_for(MAIN["arch"], layers=2, attn_impl=impl,
                                reduced=True)
        sp = M.init_params(torch.Generator(dev).manual_seed(2), scfg, dev)
        sprompt = torch.randint(0, scfg.vocab_size, (3, 40),
                                generator=torch.Generator(dev).manual_seed(3),
                                device=dev)
        small[impl] = serve.serve(sp, scfg, sprompt, 6)
    err = float((small["flash"]["prefill_logits"]
                 - small["reference"]["prefill_logits"]).abs().max())
    same = torch.equal(small["flash"]["tokens"], small["reference"]["tokens"])
    print(f"[check] reduced llama-65b fp32 flash vs reference arm: prefill logits "
          f"max_abs_err {err:.3e} (tol 2e-4), tokens equal {same}")
    if err > 2e-4 or not same:
        fail("flash arm disagrees with the reference arm")
    del small, sp, sprompt
    torch.cuda.empty_cache()

    # -- 6. the training path ----------------------------------------------------------
    train_counts = train_path(torch, dev, smi)

    # -- 7. is the training path right ---------------------------------------------------
    train_checks(torch, dev)

    # -- 8. the fused softmax kernels and the op's path -------------------------------
    fs_rows = fused_softmax_phase(torch, dev, gen, smi)

    # -- 9. the pipelined step at full width ---------------------------------------------
    pipe = pipeline_path(torch, dev, smi)

    # -- 10. is the pipelined path right ---------------------------------------------------
    pipeline_checks(torch, dev)

    # -- 11. the estimation path: stage gains, audits, --plan auto ------------------------
    estimate_counts = estimation_phase(torch, dev, smi)

    def by_path(name):
        return {"serve": serve_counts.get(name, 0), "train": train_counts.get(name, 0),
                **{f"pipeline {kind}": arm["counts"][name] for kind, arm in pipe.items()},
                **{path: c[name] for path, c in estimate_counts.items()}}

    print(json.dumps({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_fwd_sm90.cu",
         "fp32_source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "sass": sass.get("flash_attention_fwd_sm90"),
         "replaces": "src/repro/kernels/flash_attention.py:31",
         "launches": sum(arm["counts"]["flash_attention_fwd"] for arm in pipe.values()),
         "launches_by_path": by_path("flash_attention_fwd"),
         "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{source}.cu",
         **({"fp32_source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "sass": sass.get(source)} if source != name else {}),
         "replaces": f"src/repro/kernels/flash_attention.py:{line}",
         "launches": sum(arm["counts"][name] for arm in pipe.values()),
         "launches_by_path": by_path(name),
         "max_abs_err": bwd_err[name], "ms": bwd_ms_by[name],
         "plain_ms": plain_by[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": bwd_library_ms,
         "library_computes": "dq, dk and dv together"}
        for name, source, line in (
            ("flash_attention_dq", "flash_attention_dq_sm90", 220),
            ("flash_attention_dkv", "flash_attention_dkv_sm90", 259))
    ] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{name}.cu",
         "replaces": f"src/repro/kernels/fused_softmax.py:{line}",
         **fs_rows[name],
         "launches_by_path": {"ops.fused_softmax at (2, 104, 2048, 2048)": fs_rows[name]["launches"]},
         **({"library_computes": "dx without the scale"}
            if name == "fused_softmax_bwd" else {})}
        for name, line in (("fused_softmax_fwd", 22), ("fused_softmax_bwd", 35))]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
