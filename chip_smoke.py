#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; the kernels built from csrc/ (nvcc,
     all sources at once) with their ptxas report;
  2. every kernel against its plain PyTorch version on the card, at the
     kernel tests' shapes and tolerances and at the main path's shapes;
  3. the kernels timed at the main path's shape beside their plain version,
     one PyTorch library call as a yardstick, and the card's bound;
  4. the main path: ``repro_torch.serve`` on llama-65b at full width, 10
     layers (one stage of the paper's 8-way split of 80), batch 4, prompt
     2048, 16 generated tokens, flash attention, bf16 compute; with the
     kernel launch counts read over that run;
  5. the serve path's output checked: finite, in range, deterministic, and
     at a small fp32 size the flash arm equal to the reference arm; one
     prefill and its decode steps profiled (device busy share, top kernels).
It prints a JSON line of the kernels' numbers, then, last, the ok line. It
exits non-zero, printing no result, without a card or without the repo.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak (NVIDIA data sheet)
H100_HBM_BYTES_S = 3.35e12   # HBM3 bandwidth (NVIDIA data sheet)

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
MAIN = dict(arch="llama-65b", layers=10, batch=4, prompt=2048, gen=16)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def tol(dtype):
    return 2.5e-2 if dtype == "bfloat16" else 3e-5


# The kernel and its plain version both compute in fp32 from the same
# inputs. In bf16 they can differ by one bf16 rounding of O (at most 2**-7
# of |O|) and by fp32 rounding of the fp32 LSE, so beside the tests' 2.5e-2
# every bf16 O element is held to O_ATOL + O_RTOL * |O| and the LSE to
# LSE_TOL: a wrong P V sum in a few rows cannot hide under the wide bound.
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
    b, sq, nq, hd = q.shape
    sk = k.shape[1]
    pairs = 0
    for i in range(sq):
        hi = min(sk, i + q_offset + 1) if causal else sk
        lo = max(0, i + q_offset - window + 1) if window else 0
        pairs += max(0, hi - lo)
    flops = 4.0 * b * nq * hd * pairs
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse))
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = ["flash_attention_fwd"]
    t0 = time.perf_counter()
    build.build(kernels)
    print(f"[build] {len(kernels)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

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
    cases.append(dict(b=2, sq=200, sk=200, nq=8, nkv=8, hd=64, dtype="float32",
                      window=0, softcap=0.0, q_offset=0, name="strided",
                      strided=True))
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
        torch.cuda.synchronize()
        want_out, want_lse = ref.flash_attention_ref(q, k, v, **kw)
        o_err, lse_err, ok = agree(torch, out, want_out, lse, want_lse,
                                   c["dtype"])
        extra = (f"; O within {O_ATOL} + {O_RTOL}|O|, LSE within {LSE_TOL}"
                 if c["dtype"] == "bfloat16" else "")
        print(f"[check] flash_attention_fwd {c['name']} b{c['b']} sq{c['sq']} "
              f"sk{c['sk']} {c['nq']}/{c['nkv']}x{c['hd']} {c['dtype']} "
              f"w{c['window']} cap{c['softcap']} off{c['q_offset']}: "
              f"max_abs_err O {o_err:.3e} LSE {lse_err:.3e} "
              f"(tol {tol(c['dtype'])}{extra}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash_attention_fwd disagrees with its plain version: {c}")
        max_err = max(max_err, o_err, lse_err)
        del q, k, v, out, lse, want_out, want_lse
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

    # -- 4. the main path ------------------------------------------------------------
    cfg = serve.config_for(MAIN["arch"], layers=MAIN["layers"], attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (MAIN["batch"], MAIN["prompt"]),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    fa.flash_attention_fwd.launches = 0
    runs = [serve.serve(params, cfg, prompts, MAIN["gen"]) for _ in range(2)]
    launches = fa.flash_attention_fwd.launches
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
    print(f"[serve] flash_attention_fwd launches {launches} over "
          f"{prefill_calls} prefill calls")
    if launches != cfg.num_layers * prefill_calls:
        fail(f"flash kernel launched {launches} times, want "
             f"{cfg.num_layers} x {prefill_calls}")

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

    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
