#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; the kernels built from csrc/ (nvcc,
     all sources at once) with their ptxas report, and the count of HGMMA
     and UTMALDG instructions in each sm90 library (``cuobjdump -sass``);
  2. every kernel against its plain PyTorch version on the card, at the
     kernel tests' shapes and tolerances, at the bf16 route's own cases
     (``SM90_SWEEP``), at the main paths' shapes and at full-width sequence
     slices (``SLICED``: q_offset 1024 and 1536 over 2048 keys): the flash
     forward (two runs bit-equal), and the backward's dq and dk/dv kernels
     (two runs bit-equal); each check prints its route (``sm90`` for bf16,
     ``fma`` for fp32) and the C entry points it took;
  3. the kernels timed at the main paths' shapes beside their plain
     versions (one each: the forward, the dq pass, the dk/dv pass), one
     PyTorch library call as a yardstick, and the card's bound; the whole
     backward (D, dq and dk/dv) beside SDPA's; the three kernels again at
     the ``SLICED`` shapes beside SDPA under the same (lower-right) mask;
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
 12. (run right after phase 9, on its params and batches) the sequence-
     sliced pipelined step (``ScheduleSpec.seq_chunks``), ``SLICED_RUNS``:
     1f1b at c 2 and c 4, bpipe at c 2, 1f1b c 2 under host_offload; then
     the long-context run ``LONG`` (4 x 8192 tokens, c 4); each with step
     ms, tokens/s, peak stash against the compiled plan's, swaps, peak
     memory, each unit's real saved bytes beside ``sliced_unit_bytes`` and
     the flash launch counts (m c layers a step); checks the peaks, 1f1b c 2
     == bpipe c 2 bit for bit, each sliced loss and per-leaf grad norm
     against phase 9's unsliced step (``SLICED_LOSS_TOL``,
     ``SLICED_NORM_RTOL``), memory_allocated falling by a box's bytes at
     each OFFLOAD; and at a small fp32 size a sliced step on the card
     against the CPU and against the unsliced step;
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
     auto`` at full width (``AUTO``); each path's flash launch counts;
 13. the other families: the flash kernels at head_dim 256 (``HD256``:
     recurrentgemma-2b's local layer at s 2048 and 4096, gemma2-9b's) in
     bf16 and fp32, and at the families' own bf16 shapes (``FAMILY_ATTN``:
     granite-moe-1b-a400m's attention at b 4, forward and backward,
     recurrentgemma-2b's serve prefill at b 4, forward, whisper-small's
     decoder at b 8 x 448, forward and backward, and its serve prefill at
     b 4 x 432, forward, internvl2-1b's GQA group of 7 at b 4 x 2048 and
     its pipelined microbatch at b 1 x 1792, forward and backward, and
     llama-65b's local heads in phase 15's sharded step, b 4 x 16 heads on
     mesh (1, 4) and b 2 x 32 on (2, 2), and granite's, b 4 x 4/2 heads on
     (1, 4), forward and backward), against
     their plain versions, twice bit-equal (a bf16 grad element past 2.5e-2
     one ulp off only at a rounding tie that the float64 gradient
     witnesses, on the rows so marked), HD256's first shape and
     ``FAMILY_TIMED`` timed beside SDPA and the bound;
     then ``FAMILIES``: granite-moe-1b-a400m (full width and depth),
     recurrentgemma-2b (full width; 26 layers served, 9 trained and
     pipelined), xlstm-125m (mLSTM and sLSTM, full width, 8 of 12 layers),
     whisper-small (12 encoder layers over 1500 frames, 12 decoder layers
     of 448 tokens) and internvl2-1b (256 prefix embeddings before the
     tokens): ``launch.train`` (5 steps, Adam), the pipelined step (1f1b
     and bpipe, 3 steps each, 1 for xlstm-125m; whisper-small has none, as
     in the JAX twin, internvl2-1b's is text-only) and ``serve`` (b 4, 16
     new tokens): step ms, tokens/s, MFU over the active parameters (an
     encoder-decoder's encoder and cross attention as ``core/flops``
     counts them), peak memory, stash peaks against the
     compiled plan's, swaps, flash launch counts, and a profile of each
     split into GEMMs, flash, elementwise work and the RG-LRU scan, MoE
     dispatch and combine, mLSTM chunk, sLSTM scan and whisper encoder
     ranges; checks 1f1b == bpipe losses bit for bit, finite losses, the
     peaks, every path's flash launches equal to its attention layers
     times its passes (0 on xlstm-125m), and each family at a small fp32
     size on the card against the CPU (loss, grads, serve logits and
     tokens);
 14. the SPMD pipeline (``pipeline/spmd.py``): ``make_spmd_train_loss`` on
     llama-65b at full width, 4 layers, p 4 (one layer a rank), data 1, B 4
     x 2048 in m 4 microbatches, flash, bf16 compute, fp32 params, as four
     gloo ranks spawned on the one card (``launch.ranks``; their hops staged
     through host memory, so the times say nothing of NVLink), the remat
     and the bpipe_stash arm, 3 loss-and-grad steps each: step ms (the
     slowest rank's, median), tokens/s, each rank's peak memory, flash
     launches and collective ops, bytes and host seconds a step; checks the
     two arms bit for bit equal, the loss and each grad leaf elementwise
     against a single-device reference on the same params
     (``SPMD_LOSS_TOL``, ``SPMD_GRAD_RTOL``), the hops per step
     (``spmd_hops``: 2(m + p - 1) - 1, and 2(m + p - 1) more under
     bpipe_stash, ``spmd_hop_bytes`` each) and the flash launches per rank
     (``spmd_flash_launches``), and the same program small in fp32 on the
     card against the CPU; meanwhile ``launch.pipeline_dryrun`` runs both
     archs on the single production mesh (a fake process group of 256
     ranks, host only) and its bpipe files must hold 2(m + p - 1) more
     permutes a step;
 15. the sharded train step (``make_train_step(cfg, tcfg, mesh)``, DTensors
     placed by ``sharding/rules.py``): llama-65b at full width as four ranks
     of the one card on meshes (data 1, model 4) at 2 layers and (2, 2) at 1
     layer, and granite-moe-1b-a400m on (1, 4) at ``GRANITE_SHARDED_LAYERS``
     (its odd tied vocab, the experts over "model", the dispatch on each
     rank's rows; ``SHARDED``), B 4 x 2048, bf16 compute, fp32 params and moments,
     flash on each rank's local heads, 3 steps a mesh, the collectives of CUDA
     tensors staged through pinned host memory into gloo
     (``launch/staged.py``): step ms (the slowest rank's, median), tokens/s,
     each rank's peak memory, collective ops and bytes a step by kind, the
     relocations; checks the grads (``make_loss_grad`` on the mesh) and the
     first step's loss and updated params on every rank's slices against the single-device step on the same params
     and batch (``SHARDED_LOSS_RTOL``, ``SHARDED_RTOL``), the same step small
     in fp32 at the executor's tolerances (granite's at full width and 2
     layers, ``SHARDED_FP32_FULL``), the tokens whose expert choices differ
     from the single-device step's (printed; no bar depends on them), one
     loss on every rank, the flash launches per rank (layers x steps) and
     the row's seconds (reference and ranks).
 16. (run first, after phase 1) the rope kernel (``csrc/rope.cu``, q and k in one launch a direction): its forward against the plain chain bit for bit and its
     backward against the float64 grads at the bf16 bars, then both
     directions timed beside the plain chain and the bound at granite-moe's
     microbatch (b 4 x 2048, 16/8 x 64) and gpt3-96b's (b 1 x 2048, 104/104 x
     96), and its launches on the pipelined step (``ROPE_PIPE``: one forward
     and one backward a layer and microbatch). ``python3 -c "import
     chip_smoke; chip_smoke.rope_main()"`` runs phases 1 and 16 alone.
     Every path's rope launches are read from its own run with the flash
     launches (``counts_read``): phases 14 and 15's ranks must launch rope
     exactly as often as the flash forward and dq (``rope_launches``), and
     every path at least as often (``rope_short``), so no rotary embedding
     beside a flash call leaves the kernel.
It prints a JSON line of the kernels' numbers, then, last, the ok line. It
exits non-zero, printing no result, without a card or without the repo.
"""
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# full-width sequence slices of the bf16 route, b, sq, sk, nq, nkv, hd,
# q_offset: the second of two and the last of four slices of a llama-65b
# sequence of 2048 (64 x 128 heads), and the second of two of gpt3-96b's
# (104 x 96): queries see a prefix of q_offset keys whole and their own
# slice's keys causally
SLICED = [(1, 1024, 2048, 64, 64, 128, 1024),
          (1, 512, 2048, 64, 64, 128, 1536),
          (1, 1024, 2048, 104, 104, 96, 1024)]
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
# a unit's real saved bytes in phase 9 and the audit while autograd still
# saved each weight's bf16 copy, before ``layers.cast_matmul`` (PERF.md §6)
UNIT_GIB_WITH_COPIES = "2.315-3.204"
# phase 12, the sequence-sliced pipelined step on phase 9's model, params and
# batches: (kind, seq_chunks, residency, steps); the last ``steps`` batches
# run, so every arm's last step is phase 9's last batch
SLICED_RUNS = [("1f1b", 2, "none", 3), ("bpipe", 2, "none", 3),
               ("1f1b", 4, "none", 2), ("1f1b", 2, "host_offload", 2)]
# the long-context run, where slicing is meant to pay: 4 x 1 x 8192 tokens
# in 4 slices. Reckoned peak (PERF.md): 14.1 GiB of params, as much again of
# grads, and a stash of [7, 6, 5, 4] slice units of about 1.0-1.3 GiB
LONG = dict(kind="1f1b", seq=8192, seq_chunks=4, steps=2)
# bf16 bars of a sliced step against phase 9's unsliced step on the same
# batch: loss (an fp32 mean over 8192 nlls) within phase 9's 1e-2 against
# loss_fn, each leaf's grad norm within 1e-2 of it relatively. The two run
# other GEMM shapes (slices of 1024 or 512 rows against 2048), so bf16
# activations round apart.
SLICED_LOSS_TOL, SLICED_NORM_RTOL = 1e-2, 1e-2
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
# phase 13, the other families. The flash kernels at head_dim 256: b, s, nq,
# nkv, hd, window, softcap, label (causal). The first is timed.
HD256 = [(1, 2048, 10, 1, 256, 2048, 0.0, "recurrentgemma-2b local layer"),
         (1, 4096, 10, 1, 256, 2048, 0.0, "recurrentgemma-2b, the window cuts"),
         (1, 2048, 16, 8, 256, 4096, 50.0, "gemma2-9b layer")]
# the shapes the families' main paths give the kernels beside HD256's, in
# bf16, their compute dtype: b, s, nq, nkv, hd, window, softcap, label,
# backward too, and the grads' bar (causal). Granite trains and serves at b
# 4 (its pipelined microbatches are b 1 of the same instance);
# recurrentgemma serves at b 4, forward only, and trains at HD256's first
# shape. whisper-small's decoder trains at b 8 x 448 (3.5 tiles of 128
# query rows) and prefills at b 4 x 432 (6.75 tiles of 64 keys).
# internvl2-1b trains and serves at b 4 x 2048 and runs its pipelined
# microbatches at b 1 x 1792 text tokens, with a GQA group of 7. The bar:
# "flat" is phases 2-3's (2.5e-2 and the element bound); "ulp" lets an
# element past 2.5e-2 differ by one bf16 ulp only where the gradient's
# float64 value witnesses a rounding tie (``grad_agree_ulp``): dK and dV sum
# the group's heads x 2048 rows and reach |want| >= 4, where one ulp is
# 3.125e-2 (ROADMAP queue C). The last three rows are phase 15's: llama-65b's
# sharded step runs the kernels on each rank's local heads and batch rows,
# 64 heads over "model" 4 at b 4, over "model" 2 at b 4 / data 2; the last,
# granite's 16/8 heads over "model" 4 at b 4.
# FAMILY_TIMED's shapes are timed beside SDPA and the bound.
FAMILY_ATTN = [(4, 2048, 16, 8, 64, 0, 0.0, "granite-moe-1b-a400m train and serve", True, "ulp"),
               (4, 2048, 10, 1, 256, 2048, 0.0, "recurrentgemma-2b serve prefill", False, "ulp"),
               (8, 448, 12, 12, 64, 0, 0.0, "whisper-small decoder", True, "flat"),
               (4, 432, 12, 12, 64, 0, 0.0, "whisper-small serve prefill", False, "flat"),
               (4, 2048, 14, 2, 64, 0, 0.0, "internvl2-1b", True, "ulp"),
               (1, 1792, 14, 2, 64, 0, 0.0, "internvl2-1b pipelined microbatch", True, "ulp"),
               (4, 2048, 16, 16, 128, 0, 0.0, "llama-65b sharded (1, 4) local heads", True, "ulp"),
               (2, 2048, 32, 32, 128, 0, 0.0, "llama-65b sharded (2, 2) local heads", True, "ulp"),
               (4, 2048, 4, 2, 64, 0, 0.0, "granite-moe-1b-a400m sharded (1, 4) local heads", True, "ulp")]
FAMILY_TIMED = ("whisper-small decoder", "internvl2-1b")
# Each family's paths: train (launch.train, Adam), the pipelined step
# (PipelineExecutor, 1f1b and bpipe, remat "flash", no Adam) and serve.
# granite-moe-1b-a400m at full width and depth. recurrentgemma-2b at full
# width: serving at all 26 layers; training and the pipelined step at 9
# (three pattern blocks): with Adam, params, grads and moments of 26 layers
# come to about 46 GiB before activations and the 2048 x 256000 logits.
# whisper-small and internvl2-1b at full width and depth; xlstm-125m at full
# width and 8 of its 12 layers (four mLSTM/sLSTM blocks, one a stage at p 4),
# cut when phase 15 took the script past 1000 s (PERF.md §4).
# whisper-small's encoder takes ENCODER_FRAMES (1500, its 30 s window) frames
# a row, its decoder 448 tokens (its published text context); it has no
# pipelined path (the JAX twin has none). internvl2-1b's rows are 256 prefix
# embeddings and 1792 tokens (make_batch cuts the text); it pipelines
# text-only, as the twin. xlstm-125m's sLSTM runs a Python loop over time,
# about 20 launches a time step forward and 25 autograd nodes backward, so
# the host sets its step: 15.24 s a train step and 73-78 s a pipelined one
# (PERF.md §6). To keep the script near half its time limit its pipelined
# step runs 1 step an arm, not 3, and ``profile_seq`` profiles its train
# step at 64 tokens a row, its pipelined step at 16 and its prefill at 128
# (the launches a time step do not change with the length; the profiler
# takes tens of microseconds on the host for each event it returns).
FAMILIES = [
    dict(arch="granite-moe-1b-a400m",
         train=dict(layers=24, batch=4, seq=2048, steps=5),
         pipe=dict(layers=24, p=4, micro=1, m=4, seq=2048, steps=3),
         serve=dict(layers=24, batch=4, prompt=2048, gen=16)),
    dict(arch="recurrentgemma-2b",
         train=dict(layers=9, batch=1, seq=2048, steps=5),
         pipe=dict(layers=9, p=3, micro=1, m=4, seq=2048, steps=3),
         serve=dict(layers=26, batch=4, prompt=2048, gen=16)),
    dict(arch="xlstm-125m",
         train=dict(layers=8, batch=4, seq=2048, steps=5),
         pipe=dict(layers=8, p=4, micro=1, m=4, seq=2048, steps=1),
         serve=dict(layers=8, batch=4, prompt=2048, gen=16),
         profile_seq=dict(train=64, pipe=16, serve=128)),
    dict(arch="whisper-small",
         train=dict(layers=12, batch=8, seq=448, steps=5),
         pipe=None,
         serve=dict(layers=12, batch=4, prompt=432, gen=16)),
    dict(arch="internvl2-1b",
         train=dict(layers=24, batch=4, seq=2048, steps=5),
         pipe=dict(layers=24, p=4, micro=1, m=4, seq=2048, steps=3),
         serve=dict(layers=24, batch=4, prompt=1792, gen=16)),
]
# phase 14, the SPMD pipeline (``pipeline/spmd.py``): four gloo ranks on the
# one card, one llama-65b layer a rank (PIPE's cut), data 1, B 4 x 2048 in m 4
# microbatches of 1 x 2048, the remat and the bpipe_stash arm, 3
# loss-and-grad steps each. Reckoned peak a rank: 3.2 GiB of its layer, 2
# GiB of the replicated table and head, as much again of grads, a stage's
# activations and, on the last rank, 4 microbatches' fp32 logits (about 2
# GiB): 12-16 GiB, 50-65 GiB for the four beside the parent's residue.
SPMD = dict(arch="llama-65b", layers=4, p=4, data=1, batch=4, seq=2048, m=4,
            steps=3, reduced=False)
# the same four-rank program small in fp32, on the card and on the CPU
SPMD_SMALL = dict(arch="llama-65b", layers=4, p=4, data=1, batch=8, seq=32, m=4,
                  steps=1, reduced=True)
SPMD_ARMS = ("remat", "bpipe")
# bars of the bpipe arm against the single-device reference: the two run the
# same layers and kernels a microbatch at a time, so they differ only in the
# order of fp32 sums: the loss absolutely, each grad leaf elementwise
# (max |got - want| / max |want|)
SPMD_LOSS_TOL, SPMD_GRAD_RTOL = 1e-4, 1e-3
SPMD_TIMEOUT_S = 600
SPMD_TRANSPORT = ("gloo, 4 ranks share one card, hops staged through host "
                  "memory: these times say nothing of NVLink")

# phase 15, the sharded train step (``train/steps.py`` with a mesh, DTensors
# placed by ``sharding/rules.py``): llama-65b at full width as four ranks
# sharing the one card (``launch.ranks``, collectives of CUDA tensors staged
# through pinned host memory by ``launch/staged.py``), B 4 x 2048, bf16
# compute, fp32 params and Adam moments, flash on each rank's local heads,
# remat none, 3 steps a mesh: (data, model, layers). Reckoned bytes: a layer's
# fp32 params are 3.24 GB, the table and head 1.05 GB each; a rank holds
# params, grads and two moments of its shard, 8.6 GB at (1, 4) x 2 layers and
# 10.7 GB at (2, 2) x 1 layer, beside its activations and the fp32 logits of
# its rows; the parent holds the reference's grads and updated params (17.2 /
# 10.7 GB).
# granite-moe-1b-a400m (d 1024, 16/8 heads of 64, 32 experts top 8, tied
# vocab 49155, which 4 does not divide: the table is relocated onto d and the
# logits are partial sums) at full width on (1, 4), the experts over "model",
# flash on 4/2 local heads a rank, depth cut to GRANITE_SHARDED_LAYERS so that
# the row takes at most 90 s (the staged collectives set its time, the tied
# logits' most of all; the row prints its seconds: PERF.md §4 and §6).
GRANITE_SHARDED_LAYERS = 3
SHARDED = dict(batch=4, seq=2048, steps=3, reduced=False,
               rows=(("llama-65b", 1, 4, 2), ("llama-65b", 2, 2, 1),
                     ("granite-moe-1b-a400m", 1, 4, GRANITE_SHARDED_LAYERS)))
# the same step small in fp32 (reduced, TF32 off) on each row's mesh; for
# granite at full width and 2 layers in fp32 (one row of 2048: its tied
# logits' collectives set the row's time), a check of its own beside the
# bf16 bars, which no flip of a near-tied expert choice relaxes
SHARDED_SMALL = dict(arch="llama-65b", batch=4, seq=32, layers=2, steps=1,
                     reduced=True)
SHARDED_FP32_FULL = dict(arch="granite-moe-1b-a400m", batch=1, seq=2048,
                         layers=2, steps=1, reduced=False, fp32=True)
# bars against the single-device step on the same params and batch: bf16 (the
# loss relatively; each leaf's max |got - want| / max |want| over the rank's
# slice: row-parallel bf16 partial sums are added in another order), and
# fp32 at the executor's tolerances (tests/test_executor.py:34-37)
SHARDED_LOSS_RTOL, SHARDED_RTOL = 1e-3, 3e-2
SHARDED_FP32_LOSS, SHARDED_FP32_ATOL, SHARDED_FP32_RTOL = 1e-5, 2e-6, 1e-4
SHARDED_TIMEOUT_S = 600
# phase 16, the rope kernel: (label, b, s, nq, nkv, hd) of the main paths'
# microbatches, each timed; and the pipelined step whose launches are counted
ROPE_TIMED = [("granite-moe-1b-a400m", 4, 2048, 16, 8, 64),
              ("gpt3-96b", 1, 2048, 104, 104, 96)]
ROPE_PIPE = dict(arch="granite-moe-1b-a400m", layers=4, p=4, micro=4, m=4, seq=2048)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def rope_phase(torch, dev, gen, smi):
    """Phase 16: the rope kernel against its plain version, timed at
    ``ROPE_TIMED`` beside the plain chain and the bound, and its launches on
    the pipelined step (``ROPE_PIPE``). Returns its row of the kernels'
    JSON line."""
    from repro_torch.core.h100 import H100_HBM_BW
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.kernels import ref
    from repro_torch.kernels import rope as rp
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor
    from repro_torch.serve import config_for

    theta, timed, max_err = 10_000.0, [], 0.0
    for label, b, s, nq, nkv, hd in ROPE_TIMED:
        q, k, gq, gk = (torch.randn((b, s, n, hd), generator=gen, device=dev)
                        .to(torch.bfloat16) for n in (nq, nkv, nq, nkv))
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        freq = rp.freqs(theta, hd // 2, dev)
        qo, ko = rp.rope_fwd(q, k, pos, freq)
        dq, dk = rp.rope_bwd(gq, gk, pos, freq)
        same = (torch.equal(qo, ref.rope_ref(q, pos, freq))
                and torch.equal(ko, ref.rope_ref(k, pos, freq))
                and torch.equal(dq, ref.rope_bwd_ref(gq, pos, freq))
                and torch.equal(dk, ref.rope_bwd_ref(gk, pos, freq)))
        errs = []
        for got, x, g in ((dq, q, gq), (dk, k, gk)):
            x64 = x.double().requires_grad_(True)
            (want,) = torch.autograd.grad(ref.rope_ref(x64, pos, freq), x64, g.double())
            errs.append(grad_agree(torch, got, want, "bfloat16"))
            del x64, want
        ok = same and all(e[1] for e in errs)
        max_err = max([max_err] + [e[0] for e in errs])
        print(f"[check] rope {label} b{b} s{s} {nq}/{nkv}x{hd} bf16: forward and "
              f"backward equal to the plain versions bit for bit {same}; backward "
              f"max_abs_err dq {errs[0][0]:.3e} dk {errs[1][0]:.3e} against float64 "
              f"(within {G_RTOL}|want| + {G_ATOL} max|want| and 2.5e-2) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the rope kernel disagrees with its plain version at {label}")
        n_bytes = 2 * (q.numel() + k.numel()) * q.element_size()
        fwd_ms = time_ms(torch, lambda: rp.rope_fwd(q, k, pos, freq), 50)
        bwd_ms = time_ms(torch, lambda: rp.rope_bwd(gq, gk, pos, freq), 50)
        dev_ms = kernel_device_ms(torch, lambda: (rp.rope_fwd(q, k, pos, freq),
                                                  rp.rope_bwd(gq, gk, pos, freq)),
                                  ["rope_kernel"], iters=20, need=False).get("rope_kernel")
        kernel_by = "profiler"
        if dev_ms is None:  # the guide's fallback: CUDA events, back to back
            dev_ms, kernel_by = min(fwd_ms, bwd_ms), "CUDA events, back to back"
        host_us = []
        for direction in (lambda: rp.rope_fwd(q, k, pos, freq),
                          lambda: rp.rope_bwd(gq, gk, pos, freq)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                direction()
            host_us.append((time.perf_counter() - t0) / 20 * 1e6)
            torch.cuda.synchronize()
        plain_fwd = time_ms(torch, lambda: (ref.rope_ref(q, pos, freq),
                                            ref.rope_ref(k, pos, freq)), 10)
        qr, kr = q.clone().requires_grad_(True), k.clone().requires_grad_(True)
        outs = (ref.rope_ref(qr, pos, freq), ref.rope_ref(kr, pos, freq))
        plain_bwd = time_ms(torch, lambda: torch.autograd.grad(
            outs, (qr, kr), (gq, gk), retain_graph=True), 10)
        bound = n_bytes / H100_HBM_BW * 1e3
        timed.append({"shape": [label, b, s, nq, nkv, hd], "kernel_ms": dev_ms,
                      "kernel_ms_by": kernel_by,
                      "host_us_fwd_bwd": host_us, "fwd_ms": fwd_ms,
                      "bwd_ms": bwd_ms, "plain_fwd_ms": plain_fwd,
                      "plain_bwd_ms": plain_bwd, "bound_ms": bound, "bound_by": "bytes"})
        print(f"[time] rope {label} b{b} s{s} {nq}/{nkv}x{hd} bf16: kernel "
              f"{dev_ms:.4f} ms a launch on the device ({kernel_by}; forward and "
              f"backward alike), host {host_us[0]:.1f} / {host_us[1]:.1f} us a call "
              f"forward / backward; back to back (CUDA events) forward "
              f"{fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms; bound {bound:.4f} ms "
              f"({n_bytes / 1e6:.1f} MB at {H100_HBM_BW / 1e12:.2f} TB/s); plain chain "
              f"forward {plain_fwd:.4f} ms, backward (autograd) {plain_bwd:.4f} ms; {smi}")
        del q, k, gq, gk, qo, ko, dq, dk, qr, kr, outs
        torch.cuda.empty_cache()

    t = ROPE_PIPE
    cfg = config_for(t["arch"], layers=t["layers"], attn_impl="flash")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (t["m"] * t["micro"], t["seq"] + 1),
                         generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ex = PipelineExecutor(cfg, ScheduleSpec("bpipe", t["p"], t["m"]),
                          micro_batch=t["micro"], remat="flash")
    ex.step(params, batch)
    torch.cuda.synchronize()
    before = (rp.rope_fwd.launches, rp.rope_bwd.launches)
    ex.step(params, batch)
    torch.cuda.synchronize()
    launches = (rp.rope_fwd.launches - before[0], rp.rope_bwd.launches - before[1])
    want = t["layers"] * t["m"]
    ok = launches == (want, want)
    print(f"[check] rope launches on {cfg.name}'s pipelined step (bpipe p {t['p']}, "
          f"{t['layers']} layers, m {t['m']} x {t['micro']} x {t['seq']}): forward "
          f"{launches[0]}, backward {launches[1]}, want {want} each "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the pipelined step does not launch the rope kernel once a direction "
             "a layer and microbatch")
    del ex, params, batch, toks
    torch.cuda.empty_cache()
    return {"name": "rope_qk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rope.cu",
            "replaces": "none (the JAX package leaves rope to XLA)",
            "launches_by_path": {"pipelined step, one step": {
                "rope_fwd": launches[0], "rope_bwd": launches[1]}},
            "max_abs_err": max_err, "at_shapes": timed}


def rope_main():
    """Phases 1 (the card, the rope kernel's build and its ptxas report) and
    16 alone."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {smi}")
    t0 = time.perf_counter()
    build.build(["rope"])
    print(f"[build] rope in {time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("rope", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")
    dev = torch.device("cuda")
    row = rope_phase(torch, dev, torch.Generator(dev).manual_seed(0), smi)
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


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


def bwd_bounds(q, k, v, lse, *, causal, window, q_offset=0):
    """Least time of each backward kernel on an H100, as for the forward:
    dq does 3 products per kept (query, key) pair (S, dP, dS K), dk/dv 4
    (S, dP, P^T dO, dS^T Q), 2 hd FLOP each; each reads q, k, v, dO, LSE
    and D once and writes its outputs once. Returns {name: (ms, by)}."""
    from repro_torch.core.h100 import H100_HBM_BW, H100_PEAK_BF16
    b, sq, nq, hd = q.shape
    pair_flops = 2.0 * b * nq * hd * causal_pairs(
        sq, k.shape[1], causal=causal, window=window, q_offset=q_offset)
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


def sliced_kernel_times(torch, F, fa, ref, qkv, gen, dev, smi):
    """The three flash kernels timed at the full-width slices of ``SLICED``:
    the forward by CUDA events, dq and dk/dv by the profiler's device time
    per launch, each beside its plain version, the bound for the pairs the
    causal mask keeps over the prefix and the slice, and SDPA forward and
    backward with the same mask (``causal_lower_right``: the last query sees
    every key). Returns one row per shape."""
    from torch.nn.attention.bias import causal_lower_right
    rows = []
    for b, sq, sk, nq, nkv, hd, off in SLICED:
        q, k, v = qkv(b, sq, sk, nq, nkv, hd, "bfloat16")
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        kw = dict(causal=True, q_offset=off)
        out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
        fwd_bound = attention_bound(q, k, v, out, lse, causal=True, window=0,
                                    q_offset=off)
        bounds = bwd_bounds(q, k, v, lse, causal=True, window=0, q_offset=off)
        fwd_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw), 10)
        fwd_plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                            3, warmup=1)
        split = kernel_device_ms(
            torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw),
            ["flash_dq_sm90_kernel", "flash_dkv_sm90_kernel"])
        delta = ref.flash_attention_delta(out, do, lse)
        plain = {name: time_ms(torch, lambda f=f: f(q, k, v, lse, delta, do, **kw),
                               3, warmup=1)
                 for name, f in (("flash_attention_dq", ref.flash_attention_dq_ref),
                                 ("flash_attention_dkv", ref.flash_attention_dkv_ref))}
        mask = causal_lower_right(sq, sk)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), 10)
        ot = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
            ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
        shape = f"b{b} sq{sq} sk{sk} {nq}x{hd} off{off}"
        row = {"shape": shape,
               "flash_attention_fwd": dict(ms=fwd_ms, plain_ms=fwd_plain,
                                           bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                                           library_ms=sdpa_ms),
               **{name: dict(ms=split[kname], plain_ms=plain[name],
                             bound_ms=bounds[name][0], bound_by=bounds[name][1],
                             library_ms=sdpa_bwd_ms)
                  for name, kname in (("flash_attention_dq", "flash_dq_sm90_kernel"),
                                      ("flash_attention_dkv", "flash_dkv_sm90_kernel"))}}
        for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            r = row[name]
            print(f"[time] {name} sliced {shape} bf16: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), sdpa lower-right causal "
                  f"{'forward' if name == 'flash_attention_fwd' else 'backward (dq, dk, dv together)'} "
                  f"{r['library_ms']:.4f} ms; card {smi}")
        rows.append(row)
        del q, k, v, do, out, lse, delta, qt, kt, vt, ot
        torch.cuda.empty_cache()
    return rows


def kernel_device_ms(torch, fn, names, iters=5, need=True):
    """Device time per launch of each kernel whose name holds one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn``; a name
    the profiler shows no device time for fails the run, or with ``need``
    False is left out."""
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
    if missing and need:
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


# the port's profiler ranges -> the parts of a step they time (device time
# of the kernels inside, forward range and backward node). A range without a
# backward node of its own (None) is charged the backward nodes of the
# autograd ops inside it, matched by their sequence numbers.
PROFILE_RANGES = [
    ("RG-LRU scan", ("rglru_scan", "_LinearScanBackward")),
    ("MoE dispatch", ("moe_dispatch", "IndexPutBackward0")),
    ("MoE combine", ("moe_combine", "IndexSelectBackward0")),
    ("mLSTM chunks", ("mlstm_chunk", None)),
    ("sLSTM scan", ("slstm_scan", None)),
    ("whisper encoder", ("encoder", None)),
]
BACKWARD_NODE = "autograd::engine::evaluate_function: "


def backward_of_range_us(torch, prof, key):
    """Device time (us) of the backward nodes of the autograd ops inside
    every forward range ``key``: a backward node carries its forward op's
    sequence number."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.events()
    seqs, stack = set(), [e for e in events if e.key == key and e.device_type == cpu]
    while stack:
        e = stack.pop()
        stack.extend(e.cpu_children)
        if e.sequence_nr >= 0 and not e.key.startswith("autograd::"):
            seqs.add(e.sequence_nr)
    return sum(e.device_time_total for e in events
               if e.key.startswith(BACKWARD_NODE) and e.sequence_nr in seqs)


def profile_window(torch, label, fn, top=8):
    """Run ``fn`` under torch.profiler and print the device-time breakdown:
    the kernels' summed device time against the window's wall time (the
    device's busy share), the top kernels by device time, and the device
    time inside each of ``PROFILE_RANGES`` met in the window (those kernels
    are counted in their kinds as well)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t_parse = time.perf_counter()
    # the port's own ranges show on the device timeline as annotations too:
    # they are not kernels
    ranges = {k for _, keys in PROFILE_RANGES for k in keys if k}
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
    busy_us = sum(e.self_device_time_total for e in kernels)
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f} %), "
          f"{sum(e.count for e in events)} events")
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
    parts = []
    for name, (fwd, bwd) in PROFILE_RANGES:
        # a backward node shows as "autograd::engine::evaluate_function: X"
        # around "X": take the larger of the two, not both
        # (the host-side event: its device time is its kernels', where the
        # device-side annotation of the same name spans the gaps too)
        us = [max([e.device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and k and (e.key == k or e.key.endswith(": " + k))] + [0.0])
              for k in (fwd, bwd)]
        if not us[0] and not us[1]:
            continue
        if bwd is None:
            us[1] = backward_of_range_us(torch, prof, fwd)
        parts.append(f"{name} {sum(us) / 1e3:.3f} ms ({100 * sum(us) / max(busy_us, 1):.1f} "
                     f"%; forward {us[0] / 1e3:.3f}, backward {us[1] / 1e3:.3f})")
    print(f"[profile] {label} ranges (inside the kinds above): "
          + (", ".join(parts) or "none met")
          + f"; the profile read in {time.perf_counter() - t_parse:.1f} s")


def counts_zero(fa):
    """Set every kernel's launch count to 0."""
    from repro_torch.kernels import fused_softmax as fs
    from repro_torch.kernels import rope as rp
    fa.flash_attention_fwd.launches = 0
    rp.rope_fwd.launches = 0
    rp.rope_bwd.launches = 0
    fa.flash_attention_bwd.dq_launches = 0
    fa.flash_attention_bwd.dkv_launches = 0
    fs.fused_softmax_fwd.launches = 0
    fs.fused_softmax_bwd.launches = 0


def fs_counts_read():
    from repro_torch.kernels import fused_softmax as fs
    return {"fused_softmax_fwd": fs.fused_softmax_fwd.launches,
            "fused_softmax_bwd": fs.fused_softmax_bwd.launches}


def counts_read(fa):
    from repro_torch.kernels import rope as rp
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_dq": fa.flash_attention_bwd.dq_launches,
            "flash_attention_dkv": fa.flash_attention_bwd.dkv_launches,
            "rope_fwd": rp.rope_fwd.launches, "rope_bwd": rp.rope_bwd.launches}


FLASH_KEYS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")


def flash_counts(counts):
    """The flash kernels' launches of a ``counts_read`` dict."""
    return [counts[k] for k in FLASH_KEYS]


def rope_launches(flash):
    """The rope kernel's launches beside a path's ``flash`` launches where
    every attention layer takes flash: each flash forward follows a rope
    forward in the same function (a recompute reruns both), each flash
    backward a rope backward."""
    return {"rope_fwd": flash["flash_attention_fwd"],
            "rope_bwd": flash["flash_attention_dq"]}


def rope_short(by_path):
    """The paths of ``by_path`` ({path: a ``counts_read`` dict}) whose rope
    launches fall short of their flash launches: none where every rotary
    embedding beside a flash call ran on the kernel."""
    return {path: c for path, c in by_path.items()
            if c["rope_fwd"] < c["flash_attention_fwd"]
            or c["rope_bwd"] < c["flash_attention_dq"]}


def attn_keys(cfg, seq):
    """The keys a query sees at most in each attention layer of ``cfg``:
    ``seq``, or min(seq, window) on a LOCAL layer. One entry an attention
    layer, so its length is each flash kernel's launches a pass."""
    from repro_torch.configs.base import ATTN, LOCAL
    return [min(seq, cfg.window_size) if kind == LOCAL and cfg.window_size else seq
            for kind in cfg.layer_kinds() if kind in (ATTN, LOCAL)]


def n_active(cfg):
    """The parameters a token's products use, as ``core.flops.model_flops_6nd``
    counts them."""
    from repro_torch.core.flops import model_flops_6nd
    return round(model_flops_6nd(cfg, 1, 1) / 6)


def model_flops(cfg, seq, tokens):
    """(6 N_active + 6 sum(attn_keys) d) tokens. An encoder-decoder's encoder
    and cross-attention parameters (``param_count`` less that of the same
    config without an encoder) leave N_active, and their work is counted as
    3x ``core.flops.model_flops_fwd``'s encoder and cross-attention terms
    (the encoder's layers at ENCODER_FRAMES a row, the cross K/V once a
    frame, Q, O and the scores once a token)."""
    from repro_torch.core.flops import model_flops_fwd
    n, d = n_active(cfg), cfg.d_model
    rows = tokens // seq
    f = 0
    if cfg.is_encdec:
        plain = dataclasses.replace(cfg, encoder_layers=0)
        n -= cfg.param_count() - plain.param_count()
        f = 3 * (model_flops_fwd(cfg, rows, seq) - model_flops_fwd(plain, rows, seq))
    return f + (6 * n + 6 * sum(attn_keys(cfg, seq)) * d) * tokens


MFU_FORMULA = ("(6 N_active + 6 sum over attention layers of min(s, window) d) "
               "tokens / step time / 989e12, N_active as core/flops.model_flops_6nd: "
               "param_count() less the experts a token's router does not pick "
               "(E - top_k a MoE layer) and the embedding table, the unembedding kept; "
               "an encoder-decoder's encoder and cross-attention parameters out of "
               "N_active and their work 3x core/flops.model_flops_fwd's (1500 frames "
               "a row; encoder scores with its attention layers' causal half)")


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
    mfu = model_flops(cfg, t["seq"], tokens) / step_s / H100_PEAK_BF16
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[train] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
          f"attn={cfg.attn_impl}: b{t['batch']} x {t['seq']}, {t['steps']} steps; "
          f"step {step_s * 1e3:.2f} ms (median of steps 3-5), "
          f"{tokens / step_s:.1f} tokens/s, MFU {100 * mfu:.2f} % "
          f"(= {MFU_FORMULA}; N_active {n_active(cfg)} of {cfg.param_count()}, "
          f"tokens {tokens}); peak memory {peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB; "
          f"card {smi}")
    print(f"[train] launches over the run: {counts}")
    want = cfg.num_layers * t["steps"]
    if any(v != want for v in flash_counts(counts)):
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
    Returns each arm's results (its flash launch counts among them), and
    the params and batches, which phase 12 takes up."""
    from repro_torch import serve
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor

    t = PIPE
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    bsz = t["m"] * t["micro"]
    dc = DataConfig(batch=bsz, seq_len=t["seq"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, dc, i).items()}
               for i in range(t["steps"])]
    out = {}
    for kind in ("1f1b", "bpipe"):
        ex = PipelineExecutor(cfg, ScheduleSpec(kind, t["p"], t["m"]),
                              micro_batch=t["micro"], remat="flash")
        out[kind] = pipelined_run(
            torch, dev, ex, params, batches, kind, smi, tag="pipeline",
            note=f", {UNIT_GIB_WITH_COPIES} GiB real with the bf16 weight copies "
                 f"(before cast_matmul)")
        if kind == "1f1b":  # where the time goes: one more step, profiled
            profile_window(torch, "pipelined step (1f1b)",
                           lambda: ex.step(params, batches[0]), top=12)
        del ex
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
                      for v in flash_counts(arm["counts"]))
    ok = ok_peaks and ok_bpipe and same and loss_err <= 1e-2 and ok_launches
    print(f"[check] pipelined step: 1f1b peaks {want} {ok_peaks}; bpipe under "
          f"cap {S.bpipe_cap(t['p'])} with evictions == loads > 0 {ok_bpipe}; "
          f"1f1b and bpipe loss and per-leaf grad norms bit-equal {same}; last "
          f"loss {b['loss']:.6f} vs loss_fn {ref_loss:.6f} (err {loss_err:.3e}, "
          f"tol 1e-2); flash launches {want_launches} per kernel per arm "
          f"{ok_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the pipelined step's peaks, swaps, losses or launches are wrong")
    torch.cuda.empty_cache()
    return out, params, batches


def pipeline_checks(torch, dev):
    """Phase 10: every arm of the pipeline launcher on the card against the
    CPU at a small fp32 size, and a host_offload unit's box off the card."""
    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.launch import pipeline as launch_pipeline
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
    cfg = serve.config_for(PIPE["arch"], layers=4, attn_impl="flash", reduced=True)
    params = M.init_params(torch.Generator(dev).manual_seed(6), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (4, 33),
                         generator=torch.Generator().manual_seed(7)).to(dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for remat in ("none", "attn"):
        moves = []
        spec = ScheduleSpec("1f1b", 4, 4, residency="host_offload")
        with offload_watched(torch, dev, moves):
            res = PipelineExecutor(cfg, spec, micro_batch=1, remat=remat).step(params, batch)
        base = PipelineExecutor(cfg, ScheduleSpec("1f1b", 4, 4), micro_batch=1,
                                remat=remat).step(params, batch)
        same = float(res.loss) == float(base.loss) and all(
            torch.equal(a, b) for a, b in zip(T.leaves(res.grads), T.leaves(base.grads)))
        ok = same and moves_ok(moves, res.stats.offloads)
        print(f"[check] host_offload remat={remat}: {res.stats.offloads} units "
              f"offloaded; (move, box bytes, memory_allocated change, storages, "
              f"box off the card) {moves}; loss and grads equal to plain 1f1b "
              f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"a host_offload unit left tensors on the card (remat={remat})")


@contextlib.contextmanager
def offload_watched(torch, dev, moves):
    """While open, every OFFLOAD and FETCH of a host_offload unit appends
    (move, box bytes, memory_allocated change, storages, box off the card)
    to ``moves``; each move synchronises the card before and after."""
    from repro_torch.memory import offload as mem_offload
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

    mem_offload.to_host, mem_offload.to_device = host, device
    try:
        yield
    finally:
        mem_offload.to_host, mem_offload.to_device = to_host, to_device


def moves_ok(moves, offloads, fetch_slack=512):
    """Every unit offloaded was fetched, each move left the box whole off
    (or back on) the card, and memory_allocated fell (or grew) by the box's
    bytes: at OFFLOAD each storage's block is its bytes rounded up to 512;
    at FETCH each new block is up to ``fetch_slack`` longer (the caching
    allocator hands a storage of over 1 MiB a whole free block when what
    would be left of it is 1 MiB or less, and counts all of it)."""
    return len(moves) == 2 * offloads > 0 and all(
        off and n > 0 and n <= fell <= n + (512 if move == "offload" else fetch_slack) * k
        for move, n, fell, k, off in moves)


def pipelined_run(torch, dev, ex, params, batches, label, smi, tag, moves=None,
                  note=""):
    """Steps of ``ex`` over ``batches``, with the flash counts set to 0
    just before and read just after, the peak memory and each unit's real
    saved bytes beside the memory model's; prints one line, ending in
    ``note``. ``moves`` collects each OFFLOAD and FETCH. Returns the last
    step's numbers."""
    import statistics

    from repro_torch import tree as T
    from repro_torch.core import memory_model as mm
    from repro_torch.core.notation import Notation
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import flash_attention as fa

    spec, cfg = ex.spec, ex.cfg
    c = spec.seq_chunks
    seq = batches[0]["tokens"].shape[1]
    n = Notation(a=cfg.num_heads, b=ex.b, h=cfg.d_model, l=cfg.num_layers, s=seq,
                 v=cfg.vocab_size, B=spec.m * ex.b, p=spec.p, t=1)
    compiled = compile_plan(spec).peak_stash
    real = []
    watch = offload_watched(torch, dev, moves) if moves is not None \
        else contextlib.nullcontext()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts_zero(fa)
    times, res = [], None
    with unit_bytes_recorded(real), watch:
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
    tokens = batches[0]["tokens"].numel()
    modelled = mm.sliced_unit_bytes(n, "flash", 1, c)
    out = dict(counts=counts, loss=float(res.loss), stats=st, step_ms=1e3 * step_s,
               peak=peak, compiled=compiled, real=(min(real), max(real)),
               norms=[float(g.float().norm()) for g in T.leaves(res.grads)])
    del res
    print(f"[{tag}] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
          f"attn={cfg.attn_impl} {label}: "
          f"p{spec.p} m{spec.m} x {ex.b} x {seq}, c {c} (slices of {seq // c}): steps "
          f"{' / '.join(f'{1e3 * t:.2f}' for t in times)} ms, median "
          f"{1e3 * step_s:.2f} ms, {tokens / step_s:.1f} tokens/s; loss "
          f"{out['loss']:.6f}; peak stash/stage {[st.peak_local[i] for i in range(spec.p)]} "
          f"(compiled {[compiled[i] for i in range(spec.p)]}), evictions {st.evictions} "
          f"loads {st.loads} offloads {st.offloads} fetches {st.fetches}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; saved bytes per unit "
          f"{min(real) / 2**30:.3f}-{max(real) / 2**30:.3f} GiB real over {len(real)} "
          f"units vs {modelled / 2**30:.4f} GiB modelled (sliced_unit_bytes, flash "
          f"arm, c {c}){note}; card {smi}")
    print(f"[{tag}] {label} launches over its {len(batches)} steps: {counts}")
    return out


def sliced_path(torch, dev, smi, params, batches, unsliced):
    """Phase 12: the sequence-sliced pipelined step on phase 9's model,
    params and batches, checked against phase 9's unsliced 1f1b step
    (``unsliced``); the long-context run; one sliced step at a small fp32
    size on the card against the CPU and against the unsliced step. Returns
    the flash launch counts of each run by label."""
    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.core.plan import ScheduleSpec, compile_plan
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor

    t = PIPE
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash")

    runs, ok_all = {}, True
    for kind, c, residency, steps in SLICED_RUNS:
        spec = ScheduleSpec(kind, t["p"], t["m"], seq_chunks=c, residency=residency)
        label = f"{kind} c{c}" + (f" {residency}" if residency != "none" else "")
        ex = PipelineExecutor(cfg, spec, micro_batch=t["micro"], remat="flash")
        moves = [] if residency == "host_offload" else None
        r = pipelined_run(torch, dev, ex, params, batches[-steps:], label, smi,
                          "sliced", moves)
        st = r["stats"]
        peaks = [st.peak_local[i] for i in range(t["p"])]
        want = [r["compiled"][i] for i in range(t["p"])]
        bounds = compile_plan(spec).bounds
        # the live store reaches the compiled peaks; under bpipe the dispatch
        # order may leave an acceptor under its compiled peak, never over it
        # or over its cap
        ok_peaks = (peaks == want if kind == "1f1b" else all(
            p_ <= w and (bounds[i] is None or p_ <= bounds[i])
            for i, (p_, w) in enumerate(zip(peaks, want))))
        loss_err = abs(r["loss"] - unsliced["loss"])
        norm_err = max(abs(a - b) / b for a, b in zip(r["norms"], unsliced["norms"]))
        want_launches = t["m"] * c * t["layers"] * steps
        ok_launches = all(v == want_launches for v in flash_counts(r["counts"]))
        ok = (ok_peaks and ok_launches and loss_err <= SLICED_LOSS_TOL
              and norm_err <= SLICED_NORM_RTOL)
        swaps = ""
        if kind == "bpipe":
            ok = ok and st.evictions == st.loads > 0
            swaps = f"; evictions == loads > 0 {st.evictions == st.loads > 0}"
        if moves is not None:
            ok_moves = moves_ok(moves, st.offloads * steps, fetch_slack=2**20)
            ok = ok and ok_moves
            swaps = (f"; (move, box bytes, memory_allocated change, storages, box off "
                     f"the card) {moves}: memory_allocated falls by the box's bytes at "
                     f"OFFLOAD (and grows by them, up to 1 MiB a storage more, at "
                     f"FETCH) {ok_moves}")
        print(f"[check] sliced {label}: peaks {peaks} vs compiled {want} {ok_peaks}; "
              f"loss {r['loss']:.6f} vs phase 9 unsliced {unsliced['loss']:.6f} (err "
              f"{loss_err:.3e}, tol {SLICED_LOSS_TOL}); per-leaf grad norms max rel "
              f"err {norm_err:.3e} (tol {SLICED_NORM_RTOL}); flash launches "
              f"{want_launches} per kernel {ok_launches}{swaps} {'ok' if ok else 'FAIL'}")
        ok_all = ok_all and ok
        runs[label] = r
        if label == "1f1b c2":  # where the time goes: one more step, profiled
            profile_window(torch, "sliced pipelined step (1f1b c2)",
                           lambda: ex.step(params, batches[-1]), top=12)
        del ex
    a, b = runs["1f1b c2"], runs["bpipe c2"]
    same = a["loss"] == b["loss"] and a["norms"] == b["norms"]
    print(f"[check] sliced 1f1b c2 and bpipe c2 loss and per-leaf grad norms "
          f"bit-equal {same} {'ok' if same else 'FAIL'}")
    if not (ok_all and same):
        fail("the sliced pipelined step's peaks, swaps, moves, losses or launches "
             "are wrong")

    # the long-context run: 4 x 8192 tokens in 4 slices
    torch.cuda.empty_cache()
    dc = DataConfig(batch=t["m"] * t["micro"], seq_len=LONG["seq"])
    long_batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, dc, i).items()}
                    for i in range(LONG["steps"])]
    spec = ScheduleSpec(LONG["kind"], t["p"], t["m"], seq_chunks=LONG["seq_chunks"])
    label = f"long {LONG['kind']} c{LONG['seq_chunks']} s{LONG['seq']}"
    ex = PipelineExecutor(cfg, spec, micro_batch=t["micro"], remat="flash")
    r = pipelined_run(torch, dev, ex, params, long_batches, label, smi, "sliced")
    peaks = [r["stats"].peak_local[i] for i in range(t["p"])]
    want = [r["compiled"][i] for i in range(t["p"])]
    want_launches = t["m"] * LONG["seq_chunks"] * t["layers"] * LONG["steps"]
    ok = (peaks == want and math.isfinite(r["loss"])
          and all(math.isfinite(x) for x in r["norms"])
          and all(v == want_launches for v in flash_counts(r["counts"])))
    print(f"[check] sliced {label}: peaks {peaks} vs compiled {want}; loss "
          f"{r['loss']:.6f} and grad norms finite; flash launches {want_launches} "
          f"per kernel {'ok' if ok else 'FAIL'}")
    if not ok:
        fail("the long-context sliced step's peaks, loss or launches are wrong")
    runs[label] = r
    del ex, long_batches
    torch.cuda.empty_cache()

    # at a small fp32 size: a sliced step on the card against the same step
    # on the CPU (phase 10's bars), and against the unsliced step at the
    # reference's sliced-parity bars (loss 1e-5, grads rtol 1e-3 / atol 1e-5)
    scfg = serve.config_for(t["arch"], layers=4, attn_impl="flash", reduced=True)
    sparams = M.init_params(torch.Generator().manual_seed(8), scfg, "cpu")
    toks = torch.randint(0, scfg.vocab_size, (4, 33),
                         generator=torch.Generator().manual_seed(9))
    sbatch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    to = lambda tree, d: T.tree_map(lambda x: x.to(d), tree)  # noqa: E731
    base = PipelineExecutor(scfg, ScheduleSpec("1f1b", 4, 4)).step(
        to(sparams, dev), to(sbatch, dev))
    for kind, c in (("1f1b", 2), ("bpipe", 2), ("1f1b", 4)):
        ex = PipelineExecutor(scfg, ScheduleSpec(kind, 4, 4, seq_chunks=c))
        got = ex.step(to(sparams, dev), to(sbatch, dev))
        want = ex.step(sparams, sbatch)
        pairs = list(zip(T.leaves(got.grads), T.leaves(want.grads)))
        cpu_loss = abs(float(got.loss) - float(want.loss))
        cpu_err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        ok_cpu = cpu_loss <= 1e-5 and all(
            bool(((a.cpu() - b).abs() <= 2e-4 + 1e-3 * b.abs()).all()) for a, b in pairs)
        pairs = list(zip(T.leaves(got.grads), T.leaves(base.grads)))
        un_loss = abs(float(got.loss) - float(base.loss))
        un_err = max(float((a - b).abs().max()) for a, b in pairs)
        ok_un = un_loss <= 1e-5 and all(
            bool(((a - b).abs() <= 1e-5 + 1e-3 * b.abs()).all()) for a, b in pairs)
        ok = ok_cpu and ok_un
        print(f"[check] sliced {kind} c{c} fp32 {scfg.num_layers} layers d{scfg.d_model} "
              f"on the card: vs the CPU loss err {cpu_loss:.3e} (tol 1e-5), grads "
              f"max_abs_err {cpu_err:.3e} (tol 2e-4 + 1e-3|want|) {ok_cpu}; vs the "
              f"unsliced 1f1b step loss err {un_loss:.3e} (tol 1e-5), grads max_abs_err "
              f"{un_err:.3e} (tol 1e-5 + 1e-3|want|) {ok_un} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"the sliced {kind} c{c} step on the card disagrees with the CPU or "
                 f"with the unsliced step")
    return {label: r["counts"] for label, r in runs.items()}


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
        if any(v != want for v in flash_counts(counts)):
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
              f"the attention it runs); {UNIT_GIB_WITH_COPIES} GiB real with the bf16 "
              f"weight copies (before cast_matmul); launches {counts}")
        want = 2 * t["m"] * t["layers"]
        ok = (not rep.missing_in_real and not rep.missing_in_sim
              and math.isfinite(rep.time_scale) and rep.time_scale > 0
              and all(v == want for v in flash_counts(counts)))
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
          and all(v == want for v in flash_counts(counts)))
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

# ---------------------------------------------------------------------------
# Phase 13: the other families (MoE, RG-LRU hybrid) and head_dim 256
# ---------------------------------------------------------------------------
def bf16_ulp(torch, w):
    """One bf16 ulp at |w| (8 significant bits): 2**(floor(log2 |w|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0 ** -126))) - 7)


def grads_float64(torch, q, k, v, do, lse, delta, *, causal, window, softcap,
                  scale, q_offset=0):
    """dq, dk, dv in float64 from the bf16 inputs and the fp32 LSE and D the
    kernels get: the plain version's arithmetic (``ref._p_ds``) with every
    step in float64 and -inf for a masked score."""
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    m = nq // nkv
    qr = q.double().reshape(b, sq, nkv, m, hd)
    dor = do.double().reshape(b, sq, nkv, m, hd)
    s = torch.einsum("bqgmh,bkgh->bgmqk", qr, k.double()) * scale
    dcap = 1.0
    if softcap:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= qpos >= kpos
    if window:
        keep &= qpos - kpos < window
    s = torch.where(keep, s, -math.inf)
    p = torch.exp(s - lse.double().permute(0, 2, 3, 1)[..., None])
    del s
    dp = torch.einsum("bqgmh,bkgh->bgmqk", dor, v.double())
    ds = p * (dp - delta.double().permute(0, 2, 3, 1)[..., None]) * dcap * scale
    del dp
    return (torch.einsum("bgmqk,bkgh->bqgmh", ds, k.double()).reshape(q.shape),
            torch.einsum("bgmqk,bqgmh->bkgh", ds, qr),
            torch.einsum("bgmqk,bqgmh->bkgh", p, dor))


# An element past 2.5e-2 is a rounding tie when its float64 value lies
# within TIE_ULPS bf16 ulps of the midpoint between the kernel's and the
# plain version's values. Over 75 such elements at FAMILY_ATTN's backward
# shapes (``chip_bf16_grad_rounding.py --family``, seeds 0-15) the float64
# value lay at most 0.0102 ulp from it (5.2e-4 at |grad| 8.8: the fp32
# sums' own error); a one-ulp fault would put it anywhere in the half ulp,
# so 1/32 lets one faulty element in 16 through.
TIE_ULPS = 1 / 32


def grad_agree_ulp(torch, got, want, dtype, exact):
    """``grad_agree``, but a bf16 element past the flat 2.5e-2 may differ by
    one bf16 ulp of |want| (|want| >= 4: the ulp is 2**-5 there and 2**-4
    from 8) where ``exact()``, the gradient in float64
    (``grads_float64``), lies between the two values and within TIE_ULPS
    ulps of their midpoint: two bf16 roundings of the same fp32 sum taken
    in another order differ by one ulp there, so no kernel could hold
    2.5e-2. The element bound G_RTOL |want| + G_ATOL max|want| stays.
    Returns (max abs error, ok, the count of elements past 2.5e-2, the
    largest distance of such an element's float64 value from the midpoint
    in ulps)."""
    if dtype != "bfloat16":
        return (*grad_agree(torch, got, want, dtype), 0, 0.0)
    g, w = got.float(), want.float()
    e = (g - w).abs()
    cap = torch.clamp_min(bf16_ulp(torch, w), 2.5e-2)
    past = e > 2.5e-2
    ok = (bool(torch.isfinite(got).all()) and bool((e <= cap).all())
          and bool((e <= G_RTOL * w.abs() + G_ATOL * w.abs().max()).all()))
    tie = 0.0
    if ok and bool(past.any()):
        x, gp, wp = exact()[past], g[past].double(), w[past].double()
        tie = float(((x - (gp + wp) / 2).abs() / (gp - wp).abs()).max())
        ok = tie <= TIE_ULPS and bool(((x - gp) * (x - wp) <= 0).all())
    return float(e.max()), ok, int(past.sum()), tie


def family_kernels(torch, F, fa, ref, qkv, gen, dev, smi):
    """The three flash kernels at head_dim 256 (``HD256``, bf16 and fp32)
    and at the families' own bf16 shapes (``FAMILY_ATTN``) against their
    plain versions, each run twice bit-equal (HD256 and the "ulp" rows with
    one bf16 ulp allowed past the flat 2.5e-2 at a rounding tie, the "flat"
    rows at phases 2-3's bars), then HD256's first shape and FAMILY_TIMED's
    timed (``time_attention``), each timed row with the errors measured at
    its own shape. Returns (the timed rows by label, max errors over every
    shape)."""
    names = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    errs = dict.fromkeys(names, 0.0)
    errs_at = {}  # (label, dtype) -> {kernel: max error at that shape}
    cases = ([(*c, ("bfloat16", "float32"), True, False) for c in HD256]
             + [(*c[:8], ("bfloat16",), c[8], c[9] == "flat") for c in FAMILY_ATTN])
    for b, s, nq, nkv, hd, w, cap, label, dtypes, backward, flat in cases:
        for dtype in dtypes:
            q, k, v = qkv(b, s, s, nq, nkv, hd, dtype)
            do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
            kw = dict(causal=True, window=w, softcap=cap)
            out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            again = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
            got = got2 = want = ()
            if backward:
                got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
                got2 = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
            torch.cuda.synchronize()
            same = (torch.equal(out, again[0]) and torch.equal(lse, again[1])
                    and all(torch.equal(a, b_) for a, b_ in zip(got, got2)))
            want_out, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            o_err, lse_err, ok = agree(torch, out, want_out, lse, want_lse, dtype)
            if backward:
                want = ref.flash_attention_bwd_ref(q, k, v, out, lse, do, **kw)
            exact64 = []

            def exact(i):
                if not exact64:
                    exact64.extend(grads_float64(
                        torch, q, k, v, do, lse, ref.flash_attention_delta(out, do, lse),
                        scale=1.0 / math.sqrt(hd), **kw))
                return exact64[i]

            gerr = [grad_agree_ulp(torch, g_, w_, dtype, lambda i=i: exact(i))
                    for i, (g_, w_) in enumerate(zip(got, want))]
            if flat:  # the tie distances are printed, the flat bar decides
                gerr = [(e[0], grad_agree(torch, g_, w_, dtype)[1], *e[2:])
                        for e, g_, w_ in zip(gerr, got, want)]
            ok = ok and same and all(e[1] for e in gerr)
            bf16 = dtype == "bfloat16"
            text = (f"O {o_err:.3e} LSE {lse_err:.3e} (within "
                    + (f"{O_ATOL} + {O_RTOL}|O|, LSE {LSE_TOL})" if bf16
                       else f"{tol(dtype)})"))
            if backward:
                cap_text = ("2.5e-2" if flat else "2.5e-2, or one bf16 ulp of |want| "
                            f"at a float64 tie within {TIE_ULPS:.4g} ulp")
                text += (f", dq {gerr[0][0]:.3e} dk {gerr[1][0]:.3e} dv "
                         f"{gerr[2][0]:.3e} (within "
                         + (f"{G_RTOL}|want| + {G_ATOL} max|want| and {cap_text}; "
                            f"elements past 2.5e-2: dq {gerr[0][2]} dk {gerr[1][2]} "
                            f"dv {gerr[2][2]}, their float64 values at most "
                            f"{max(e[3] for e in gerr):.3g} ulp from the tie)" if bf16
                            else f"{G_ATOL32} + {G_RTOL32}|want|)"))
            else:
                text += ", forward only"
            print(f"[check] head_dim {hd} {label}: b{b} s{s} {nq}/{nkv}x{hd} {dtype} "
                  f"w{w} cap{cap} route {fa.route(q.dtype)}: max_abs_err {text}; "
                  f"two runs bit-equal {same} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"a flash kernel disagrees with its plain version at a family "
                     f"shape: {label} {dtype}")
            here = {"flash_attention_fwd": max(o_err, lse_err)}
            if backward:
                here["flash_attention_dq"] = gerr[0][0]
                here["flash_attention_dkv"] = max(gerr[1][0], gerr[2][0])
            errs_at[label, dtype] = here
            for name, e in here.items():
                errs[name] = max(errs[name], e)
            del q, k, v, do, out, lse, again, got, got2, want_out, want_lse, want, exact64
            torch.cuda.empty_cache()

    timed = [HD256[0]] + [c[:8] for c in FAMILY_ATTN if c[7] in FAMILY_TIMED]
    rows = {c[7]: time_attention(torch, F, fa, ref, qkv, gen, dev, smi, *c)
            for c in timed}
    for label, row in rows.items():
        for name, r in row.items():
            r["max_abs_err"] = errs_at[label, "bfloat16"][name]
    return rows, errs


def time_attention(torch, F, fa, ref, qkv, gen, dev, smi, b, s, nq, nkv, hd, w,
                   cap, label):
    """The three kernels at one causal bf16 shape: the forward by CUDA
    events, dq and dk/dv by the profiler's device time per launch, each
    beside its plain version, the bound, and SDPA forward and backward (a
    window that does not cut computes SDPA's causal function; K/V expanded
    to the query heads before the clock). Returns {kernel: numbers}."""
    assert not w or w >= s, "SDPA's causal mask has no window"
    q, k, v = qkv(b, s, s, nq, nkv, hd, "bfloat16")
    do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
    kw = dict(causal=True, window=w, softcap=cap)
    out, lse = fa.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    fwd_bound = attention_bound(q, k, v, out, lse, causal=True, window=w)
    bounds = bwd_bounds(q, k, v, lse, causal=True, window=w)
    fwd_ms = time_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw), 10)
    fwd_plain = time_ms(torch, lambda: ref.flash_attention_ref(q, k, v, **kw), 3,
                        warmup=1)
    sm90 = ["flash_dq_sm90_kernel", "flash_dkv_sm90_kernel"]
    split = kernel_device_ms(
        torch, lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), sm90)
    delta = ref.flash_attention_delta(out, do, lse)
    plain = {name: time_ms(torch, lambda f=f: f(q, k, v, lse, delta, do, **kw), 3,
                           warmup=1)
             for name, f in (("flash_attention_dq", ref.flash_attention_dq_ref),
                             ("flash_attention_dkv", ref.flash_attention_dkv_ref))}
    kx, vx = (t.repeat_interleave(nq // nkv, dim=2) for t in (k, v))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, kx, vx))
    sdpa_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_bwd_ms = time_ms(torch, lambda: torch.autograd.grad(
        ot, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 10)
    shape = f"b{b} s{s} {nq}/{nkv}x{hd} w{w} ({label})"
    row = {"flash_attention_fwd": dict(ms=fwd_ms, plain_ms=fwd_plain,
                                       bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                                       library_ms=sdpa_ms)}
    for name, kname in zip(("flash_attention_dq", "flash_attention_dkv"), sm90):
        row[name] = dict(ms=split[kname], plain_ms=plain[name],
                         bound_ms=bounds[name][0], bound_by=bounds[name][1],
                         library_ms=sdpa_bwd_ms)
    for name, r in row.items():
        r["shape"] = shape
        print(f"[time] {name} {shape} bf16: kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), sdpa causal "
              f"{'forward' if name == 'flash_attention_fwd' else 'backward (dq, dk, dv together)'} "
              f"{r['library_ms']:.4f} ms; card {smi}")
    del q, k, v, do, out, lse, delta, kx, vx, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return row


def family_train(torch, dev, smi, fam):
    """The launcher's training loop (Adam) on one family; returns its flash
    launch counts."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.h100 import H100_PEAK_BF16
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import ENCODER_FRAMES
    from repro_torch.train.steps import make_train_step

    t = fam["train"]
    argv = ["--arch", fam["arch"], "--layers", str(t["layers"]), "--batch",
            str(t["batch"]), "--seq", str(t["seq"]), "--steps", str(t["steps"]),
            "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts_zero(fa)
    res = launch_train.main(argv)
    counts = counts_read(fa)
    peak = torch.cuda.max_memory_allocated()
    cfg, steps = res["cfg"], res["steps"]
    step_s = sorted(st["s"] for st in steps[2:5])[1]
    tokens = t["batch"] * t["seq"]
    mfu = model_flops(cfg, t["seq"], tokens) / step_s / H100_PEAK_BF16
    total = torch.cuda.get_device_properties(0).total_memory
    rows = (f" ({cfg.num_prefix_embeds} prefix embeddings + "
            f"{t['seq'] - cfg.num_prefix_embeds} tokens)" if cfg.frontend == "vision"
            else f", {cfg.encoder_layers} encoder layers over {ENCODER_FRAMES} frames "
                 f"a row" if cfg.is_encdec else "")
    print(f"[family train] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} {cfg.dtype} "
          f"attn={cfg.attn_impl}: b{t['batch']} x {t['seq']}{rows}, {t['steps']} steps; "
          f"losses {[round(st['loss'], 6) for st in steps]}; step "
          f"{step_s * 1e3:.2f} ms (median of steps 3-5), {tokens / step_s:.1f} "
          f"tokens/s, MFU {100 * mfu:.2f} % (= {MFU_FORMULA}; N_active "
          f"{n_active(cfg)} of {cfg.param_count()}); peak memory "
          f"{peak / 2**30:.2f} GiB of {total / 2**30:.2f} GiB; card {smi}")
    print(f"[family train] {cfg.name} launches over the run: {counts}")
    want = len(attn_keys(cfg, 1)) * t["steps"]
    if any(v != want for v in flash_counts(counts)):
        fail(f"{cfg.name} training launched {counts}, want {want} of each kernel")
    if not all(math.isfinite(st["loss"]) and math.isfinite(st["grad_norm"])
               for st in steps):
        fail(f"a {cfg.name} training loss or grad norm is not finite")
    if peak >= total:
        fail(f"peak memory {peak} is not under the card's {total}")
    seq = fam.get("profile_seq", {}).get("train", t["seq"])
    tcfg = dataclasses.replace(TrainConfig(), steps=t["steps"], seq_len=seq)
    step_fn = make_train_step(cfg, tcfg)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, DataConfig(batch=t["batch"], seq_len=seq), 0).items()}
    box = {"p": res["params"], "o": res["opt"]}

    def one_step():
        box["p"], box["o"], _ = step_fn(box["p"], box["o"], batch)

    profile_window(torch, f"{cfg.name} train step (b{t['batch']} x {seq})",
                   one_step, top=12)
    del res, box, batch
    torch.cuda.empty_cache()
    return counts


def family_pipeline(torch, dev, smi, fam):
    """The pipelined step on one family under 1f1b and bpipe; returns each
    arm's flash launch counts."""
    from repro_torch import serve
    from repro_torch.core import schedule as S
    from repro_torch.core.plan import ScheduleSpec
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import model as M
    from repro_torch.pipeline import PipelineExecutor

    t = fam["pipe"]
    if t is None:
        print(f"[family pipeline] {fam['arch']}: no pipelined step, skipped: the "
              f"JAX twin has no encoder-decoder pipeline (its stages carry no "
              f"encoder), and the port's PipelineExecutor raises for one")
        return {}
    cfg = serve.config_for(fam["arch"], layers=t["layers"], attn_impl="flash")
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    dc = DataConfig(batch=t["m"] * t["micro"], seq_len=t["seq"])
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(cfg, dc, i).items()}
               for i in range(t["steps"])]
    seq = fam.get("profile_seq", {}).get("pipe", t["seq"])
    profiled = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, dataclasses.replace(dc, seq_len=seq), 0).items()}
    out = {}
    for kind in ("1f1b", "bpipe"):
        ex = PipelineExecutor(cfg, ScheduleSpec(kind, t["p"], t["m"]),
                              micro_batch=t["micro"], remat="flash")
        out[kind] = pipelined_run(torch, dev, ex, params, batches, kind, smi,
                                  tag=f"{cfg.name} pipeline")
        if kind == "1f1b":
            profile_window(torch, f"{cfg.name} pipelined step (1f1b, m {t['m']} x "
                           f"{t['micro']} x {profiled['tokens'].shape[1]})",
                           lambda: ex.step(params, profiled), top=12)
        del ex
    a, b = out["1f1b"], out["bpipe"]
    p = t["p"]
    peaks = {kind: [arm["stats"].peak_local[i] for i in range(p)]
             for kind, arm in out.items()}
    compiled = {kind: [arm["compiled"][i] for i in range(p)] for kind, arm in out.items()}
    cap = S.bpipe_cap(p)
    ok_peaks = (peaks["1f1b"] == compiled["1f1b"]
                and all(x <= y for x, y in zip(peaks["bpipe"], compiled["bpipe"]))
                and max(peaks["bpipe"]) <= cap)
    swaps = b["stats"].evictions == b["stats"].loads
    same = a["loss"] == b["loss"] and a["norms"] == b["norms"]
    want = len(attn_keys(cfg, 1)) * t["m"] * t["steps"]
    ok_launches = all(v == want for arm in out.values()
                      for v in flash_counts(arm["counts"]))
    finite = all(math.isfinite(arm["loss"]) for arm in out.values())
    ok = ok_peaks and swaps and same and ok_launches and finite
    print(f"[check] {cfg.name} pipelined step: peaks 1f1b {peaks['1f1b']} bpipe "
          f"{peaks['bpipe']} against the compiled {compiled['1f1b']} and "
          f"{compiled['bpipe']} (bpipe cap {cap}) {ok_peaks}; bpipe evictions "
          f"{b['stats'].evictions} == loads {b['stats'].loads} {swaps}; 1f1b and "
          f"bpipe loss and per-leaf grad norms bit-equal {same} ({a['loss']!r}, "
          f"{b['loss']!r}), finite {finite}; flash launches {want} per kernel per "
          f"arm {ok_launches} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name}: the pipelined step's peaks, losses or launches are wrong")
    del params, batches, profiled
    torch.cuda.empty_cache()
    return {kind: arm["counts"] for kind, arm in out.items()}


def family_serve(torch, dev, smi, fam):
    """``serve`` on one family, twice on the same prompts; returns the
    flash launch counts over both."""
    from repro_torch import serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_serve_step

    t = fam["serve"]
    cfg = serve.config_for(fam["arch"], layers=t["layers"], attn_impl="flash")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    prompts = torch.randint(0, cfg.vocab_size, (t["batch"], t["prompt"]),
                            generator=torch.Generator(dev).manual_seed(1), device=dev)
    front = serve.frontend_inputs(cfg, t["batch"], dev, frames=M.ENCODER_FRAMES)
    counts_zero(fa)
    warm, res = [serve.serve(params, cfg, prompts, t["gen"], **front) for _ in range(2)]
    counts = counts_read(fa)
    npre = front["prefix_embeds"].shape[1] if "prefix_embeds" in front else 0
    inputs = (f" after {npre} prefix embeddings" if npre else
              f" over {front['enc_embeds'].shape[1]} encoder frames" if front else "")
    print(f"[family serve] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} {cfg.dtype} "
          f"attn={cfg.attn_impl}: b{t['batch']} prompt {t['prompt']}{inputs} gen "
          f"{t['gen']}; prefill {res['prefill_s'] * 1e3:.2f} ms (first call "
          f"{warm['prefill_s'] * 1e3:.2f} ms), decode {res['decode_tok_s']:.2f} tok/s "
          f"({res['decode_s'] * 1e3:.2f} ms for {t['gen'] - 1} steps); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {smi}")
    print(f"[family serve] {cfg.name} launches over 2 prefill calls: {counts}")
    toks = res["tokens"]
    if counts["flash_attention_fwd"] != 2 * len(attn_keys(cfg, 1)):
        fail(f"{cfg.name} serving launched {counts}, want {2 * len(attn_keys(cfg, 1))} "
             f"forwards")
    if counts["flash_attention_dq"] or counts["flash_attention_dkv"]:
        fail(f"{cfg.name} serving launched a backward kernel: {counts}")
    if tuple(toks.shape) != (t["batch"], t["gen"]) or not (
            0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size):
        fail(f"{cfg.name} tokens of shape {tuple(toks.shape)} or out of the vocabulary")
    if not all(bool(torch.isfinite(res[k]).all())
               for k in ("prefill_logits", "last_logits")):
        fail(f"{cfg.name} serve logits not finite")
    if not torch.equal(toks, warm["tokens"]):
        fail(f"two {cfg.name} serve runs of the same prompts gave different tokens")
    b, n_gen = t["batch"], t["gen"]
    sp = fam.get("profile_seq", {}).get("serve", t["prompt"])
    batch = {"tokens": prompts[:, :sp], **front}
    state = M.init_decode_state(cfg, b, sp + n_gen + npre, dev)
    serve_step = make_serve_step(cfg)
    box = {}
    with torch.inference_mode():
        def run_prefill():
            box["logits"], box["state"], box["enc"] = M.prefill(params, batch, cfg, state)

        def run_decode():
            tok = torch.argmax(box["logits"], dim=-1).to(torch.int32)
            for i in range(n_gen - 1):
                tok, _, box["state"] = serve_step(params, box["state"], tok,
                                                  sp + npre + i, box["enc"])

        profile_window(torch, f"{cfg.name} prefill (b{b} x {sp})", run_prefill)
        profile_window(torch, f"{cfg.name} decode ({n_gen - 1} steps)", run_decode)
    del params, warm, res, state, box, front, batch
    torch.cuda.empty_cache()
    return counts


def family_checks(torch, dev):
    """Each family at a small fp32 size, the card against the CPU on the
    same params and inputs (a VLM's prefix embeddings, an encoder-decoder's
    16 frames): the loss (1e-5) and grads (2e-4 + 1e-3|want|) of
    ``make_loss_grad``, the serve loop's prefill and last decode logits
    (2e-4) and its greedy tokens (equal). The MoE routes on fp32 random
    inputs, so no two router probabilities tie; 32 tokens take xlstm-125m's
    mLSTM through two chunks of 16."""
    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_loss_grad

    for fam in FAMILIES:
        cfg = serve.config_for(fam["arch"], layers=4, attn_impl="flash", reduced=True)
        cpu_params = M.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
        params = T.tree_map(lambda t: t.to(dev), cpu_params)
        g = torch.Generator().manual_seed(8)
        toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
        labels = toks[:, 1:].clone()
        labels[0, :4] = -1
        cpu = torch.device("cpu")
        batch = {"tokens": toks[:, :-1], "labels": labels,
                 **serve.frontend_inputs(cfg, 2, cpu, frames=16)}
        lg = make_loss_grad(cfg, TrainConfig())
        c_loss, c_grads = lg(cpu_params, batch)
        d_loss, d_grads = lg(params, {k: v.to(dev) for k, v in batch.items()})
        loss_err = abs(float(d_loss) - float(c_loss))
        pairs = list(zip(T.leaves(d_grads), T.leaves(c_grads)))
        g_err = max(float((a.cpu() - b).abs().max()) for a, b in pairs)
        g_ok = all(bool(((a.cpu() - b).abs() <= 2e-4 + 1e-3 * b.abs()).all())
                   for a, b in pairs)
        prompts = torch.randint(0, cfg.vocab_size, (3, 20), generator=g)
        front = serve.frontend_inputs(cfg, 3, cpu, frames=16)
        c_res = serve.serve(cpu_params, cfg, prompts, 6, **front)
        d_res = serve.serve(params, cfg, prompts.to(dev), 6,
                            **{k: v.to(dev) for k, v in front.items()})
        l_err = max(float((d_res[k].cpu() - c_res[k]).abs().max())
                    for k in ("prefill_logits", "last_logits"))
        same = torch.equal(d_res["tokens"].cpu(), c_res["tokens"])
        ok = loss_err <= 1e-5 and g_ok and l_err <= 2e-4 and same
        print(f"[check] reduced {fam['arch']} fp32, 4 layers, card vs CPU: loss "
              f"{float(d_loss):.7f} err {loss_err:.3e} (tol 1e-5), grads max_abs_err "
              f"{g_err:.3e} (tol 2e-4 + 1e-3|want|), prefill and last decode logits "
              f"max_abs_err {l_err:.3e} (tol 2e-4), greedy tokens equal {same} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"reduced {fam['arch']} on the card disagrees with the CPU")
    torch.cuda.empty_cache()


def families_phase(torch, F, fa, ref, qkv, gen, dev, smi):
    """Phase 13. Returns (the timed kernel rows by shape and the errors, the
    flash launch counts by path). Every path's counts must be exactly its
    attention layers times its passes: 0 on xlstm-125m, whisper-small's
    decoder self attention only (its encoder and cross attention take
    ``_sdpa``), no backward kernel while serving."""
    timed = family_kernels(torch, F, fa, ref, qkv, gen, dev, smi)
    counts, want = {}, {}
    for fam in FAMILIES:
        name = fam["arch"]
        counts[f"{name} train"] = family_train(torch, dev, smi, fam)
        want[f"{name} train"] = (n_attn(fam, "train") * fam["train"]["steps"],) * 3
        for kind, c in family_pipeline(torch, dev, smi, fam).items():
            counts[f"{name} pipeline {kind}"] = c
            t = fam["pipe"]
            want[f"{name} pipeline {kind}"] = (
                n_attn(fam, "pipe") * t["m"] * t["steps"],) * 3
        counts[f"{name} serve"] = family_serve(torch, dev, smi, fam)
        want[f"{name} serve"] = (2 * n_attn(fam, "serve"), 0, 0)
    family_checks(torch, dev)
    keys = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    wrong = {path: (counts[path], dict(zip(keys, w))) for path, w in want.items()
             if tuple(counts[path][k] for k in keys) != w}
    print(f"[check] phase 13 flash launches, each path against its attention layers "
          f"times its passes: {len(want) - len(wrong)} of {len(want)} paths exact "
          f"{'ok' if not wrong else 'FAIL'}")
    if wrong:
        fail(f"flash launches differ from the attention layers times the passes: {wrong}")
    return timed, counts


def spmd_hops(m, p, bpipe):
    """The collective-permutes a rank runs in one loss-and-grad step of the
    SPMD pipeline, T = m + p - 1 ticks: T shifts forward, T - 1 backward (the
    last tick's shift has no reader, so no backward), and under bpipe_stash
    one EVICT and one LOAD a tick: 2T - 1, or 4T - 1."""
    t = m + p - 1
    return 2 * t - 1 + (2 * t if bpipe else 0)


def spmd_hop_bytes(mb, seq, d, itemsize):
    """One hop's bytes: a microbatch's activations, mb x s x d."""
    return mb * seq * d * itemsize


def spmd_flash_launches(m, p, layers, steps):
    """Each flash kernel's launches on one rank over ``steps`` steps: every
    one of the m + p - 1 ticks runs the stage's layers forward, again in the
    backward's recompute (both arms recompute), and once backward."""
    n = (m + p - 1) * (layers // p) * steps
    return {"flash_attention_fwd": 2 * n, "flash_attention_dq": n,
            "flash_attention_dkv": n}


def spmd_rank(rank, world, t, device, init_device, ref=None):
    """Phase 14 on one rank (spawned by ``launch.ranks.run_ranks``): this
    rank's stage of ``t``'s model drawn on ``init_device`` from seed 0,
    both arms over the same params and batches, each step timed on this
    rank (a barrier before, a synchronise after), the flash counts set to 0
    just before each arm and read just after, the collective counter read
    each step. The two arms' last losses and grads are compared bit for bit
    here (the first arm's grads wait on the host). With ``ref``
    (``spmd_reference``'s loss and grads, the grads shared from the parent)
    the bpipe arm's last loss and grads are held to it here
    (``spmd_ref_errs``). Returns numbers, and the last step's grads as numpy
    when ``t`` is small."""
    import torch
    import torch.distributed as dist

    from repro_torch import serve
    from repro_torch import tree as T
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.pipeline import collectives as C
    from repro_torch.pipeline import spmd

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash",
                           reduced=t["reduced"])
    mesh = make_host_mesh(t["data"], t["p"], "cpu")
    stage, d = mesh.get_local_rank("model"), mesh.get_local_rank("data")
    params = spmd.init_pipeline_params(torch.Generator(init_device).manual_seed(0),
                                       cfg, t["p"], stage, init_device)
    params = T.tree_map(lambda x: x.to(dev), params)
    lb = t["batch"] // t["data"]
    batches = [{k: torch.from_numpy(v[d * lb:(d + 1) * lb]).to(dev)
                for k, v in make_batch(cfg, DataConfig(batch=t["batch"],
                                                       seq_len=t["seq"]), i).items()}
               for i in range(t["steps"])]
    out = {"stage": stage, "data": d, "arms": {},
           "transport": C.transport(dist.group.WORLD)}
    first = None
    for arm in SPMD_ARMS:
        step = spmd.make_spmd_train_loss(cfg, mesh, t["p"], t["m"],
                                         bpipe_stash=arm == "bpipe")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        counts_zero(fa)
        times, losses, counters = [], [], []
        for batch in batches:
            loss = grads = None  # the last step's grads go before this step's come
            dist.barrier()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            C.reset()
            loss, grads = step(params, batch)
            if cuda:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counters.append(C.read())
            losses.append(float(loss))
        counts = counts_read(fa)
        named = [("/".join(map(str, path)), g) for path, g in T.leaves_with_paths(grads)]
        res = {"times": times, "losses": losses, "counters": counters,
               "counts": counts,
               "peak": torch.cuda.max_memory_allocated() if cuda else None,
               "norms": {k: float(g.float().norm()) for k, g in named}}
        if t["reduced"]:
            res["grads"] = {k: g.cpu().numpy() for k, g in named}
        if ref is not None and arm == "bpipe":
            out["ref_loss_err"] = abs(losses[-1] - ref["loss"])
            out["ref_errs"] = spmd_ref_errs(torch, named, ref["grads"], stage)
            ref["grads"].clear()  # let go of the parent's memory now, not at exit
        if first is None:
            first = (losses[-1], [g.cpu() for _, g in named])
        else:
            out["same"] = first[0] == losses[-1] and all(
                torch.equal(a, g.cpu()) for a, (_, g) in zip(first[1], named))
        out["arms"][arm] = res
        del loss, grads, named, step
    return out


def spmd_reference(torch, dev, cfg, t, batch):
    """The twin of the JAX package's ``tests/test_spmd.py`` ``ref_loss`` on
    one device, on the params every rank drew (seed 0): each stage's layers
    in order over one microbatch at a time, the loss the mean of the
    microbatches' means (the pipeline's), grads accumulated. Returns the
    loss and each leaf's grad, keyed by ``spmd_ref_key``."""
    from repro_torch import tree as T
    from repro_torch.models.blocks import apply_layer
    from repro_torch.models.layers import apply_norm, embed, unembed
    from repro_torch.pipeline import spmd

    p, m = t["p"], t["m"]
    per, kinds = t["layers"] // p, cfg.layer_kinds()
    stages = []
    for i in range(p):
        drawn = spmd.init_pipeline_params(torch.Generator(dev).manual_seed(0), cfg,
                                          p, i, dev)
        stages.append(drawn.pop("stages"))
        shared = drawn
    params = {**shared, "stages": dict(enumerate(stages))}
    for leaf in T.leaves(params):
        leaf.requires_grad_(True)
    tokens, labels = batch["tokens"], batch["labels"]
    mb = tokens.shape[0] // m
    total = 0.0
    for micro in range(m):
        rows = slice(micro * mb, (micro + 1) * mb)
        x = embed(params["embed"], tokens[rows], cfg)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
        for i in range(p):
            for j in range(per):
                x, _ = apply_layer(params["stages"][i][j], x, cfg, kinds[j], positions)
        logits = unembed(params["embed"], apply_norm(params["final_norm"], x), cfg)
        lbl = labels[rows]
        mask = (lbl >= 0).float()
        logp = torch.log_softmax(logits.float(), -1)
        nll = -torch.gather(logp, -1, lbl.clamp_min(0).long()[..., None])[..., 0]
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        (loss / m).backward()
        total += float(loss.detach()) / m
        del x, logits, logp, nll, loss
    grads = {}
    for path, leaf in T.leaves_with_paths(params):
        if path[0] == "stages":  # as the rank of stage path[1] names it
            name, stage = "/".join(map(str, ("stages",) + path[2:])), path[1]
        else:
            name, stage = "/".join(path), None
        grads[spmd_ref_key(name, stage)] = leaf.grad
    return total, grads


def spmd_ref_key(name, stage):
    """A grad leaf's key in the reference: a rank's stage leaves under
    "stage i", the replicated leaves (embed, final_norm) under their own."""
    return f"stage {stage} {name}" if name.startswith("stages") else name


def spmd_ref_errs(torch, named, want, stage):
    """Each of a rank's grad leaves against the reference's, elementwise:
    ``{key: max |got - want| / max |want|}``."""
    errs = {}
    for name, g in named:
        w = want[spmd_ref_key(name, stage)].to(g.device)
        errs[spmd_ref_key(name, stage)] = float(
            (g - w).abs().max() / w.abs().max().clamp_min(1e-30))
    return errs


def spmd_ref_check(ranks, ref_grads):
    """Phase 14's bars over every rank's ``ref_loss_err`` and ``ref_errs``:
    (ok, the loss error, the worst leaf's error and key). Every leaf of the
    reference must be checked on some rank."""
    errs = {k: v for r in ranks for k, v in r["ref_errs"].items()}
    loss_err = max(r["ref_loss_err"] for r in ranks)
    worst, key = max((v, k) for k, v in errs.items())
    ok = (set(errs) == set(ref_grads) and loss_err <= SPMD_LOSS_TOL
          and worst <= SPMD_GRAD_RTOL)
    return ok, loss_err, worst, key


def spmd_phase(torch, dev, smi):
    """Phase 14: the SPMD pipeline on four gloo ranks of the one card. Returns
    each arm's flash launch counts summed over the ranks."""
    import statistics

    from repro_torch import serve
    from repro_torch.launch.ranks import run_ranks

    t = SPMD
    world = t["data"] * t["p"]
    # the dry run is host-only: its process runs beside the ranks
    dry_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.pipeline_dryrun", "--arch",
         "gpt3-96b", "llama-65b", "--mesh", "single", "--out", dry_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    try:
        # the single-device reference on the same params and the last batch,
        # first: its grads stay on the card, shared with the ranks, which hold
        # their own to it (CUDA IPC: nothing is copied)
        from repro_torch.data.pipeline import DataConfig, make_batch
        cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash")
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
            cfg, DataConfig(batch=t["batch"], seq_len=t["seq"]), t["steps"] - 1).items()}
        ref_loss, ref_grads = spmd_reference(torch, dev, cfg, t, batch)
        del batch
        # through the host and back, so the grads lie in blocks of their own
        # and none holds the reference's freed activations reserved
        ref_grads = {k: g.cpu() for k, g in ref_grads.items()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        ref_grads = {k: g.to(dev) for k, g in ref_grads.items()}
        print(f"[spmd] the parent before spawning (the reference's grads held): "
              f"memory_allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
              f"reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        # four processes share the card's memory: each rank's allocator maps
        # what it needs instead of holding fragmented blocks
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = run_ranks(spmd_rank, world, args=(
                t, "cuda", "cuda", {"loss": ref_loss, "grads": ref_grads}),
                timeout_s=SPMD_TIMEOUT_S, staged_key="CUDA")
        finally:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        wall = time.perf_counter() - t0
        mb = t["batch"] // t["data"] // t["m"]
        hop = spmd_hop_bytes(mb, t["seq"], cfg.d_model, 2)
        want_counts = spmd_flash_launches(t["m"], t["p"], t["layers"], t["steps"])
        want_counts.update(rope_launches(want_counts))
        tokens = t["batch"] * t["seq"]
        counts_by_arm, ok = {}, True
        for arm in SPMD_ARMS:
            rs = [r["arms"][arm] for r in ranks]
            slowest = [max(r["times"][i] for r in rs) for i in range(t["steps"])]
            step_s = statistics.median(slowest)
            counters = [c for r in rs for c in r["counters"]]
            cp = {(c["ops"]["collective-permute"], c["bytes"]["collective-permute"])
                  for c in counters}
            ar = {(c["ops"]["all-reduce"], c["bytes"]["all-reduce"]) for c in counters}
            # host seconds a rank spent in each kind of collective, its last step
            in_coll = [{k: round(r["counters"][-1]["seconds"][k] * 1e3, 2)
                        for k in ("collective-permute", "all-reduce")} for r in rs]
            n_hops = spmd_hops(t["m"], t["p"], arm == "bpipe")
            ok_hops = cp == {(n_hops, n_hops * hop)}
            ok_counts = all(r["counts"] == want_counts for r in rs)
            ok_loss = len({r["losses"][-1] for r in rs}) == 1
            ok = ok and ok_hops and ok_counts and ok_loss
            counts_by_arm[arm] = {k: sum(r["counts"][k] for r in rs) for k in want_counts}
            print(f"[spmd] {cfg.name} {cfg.num_layers} layers d{cfg.d_model} "
                  f"{cfg.num_heads}x{cfg.head_dim} ff{cfg.d_ff} {cfg.dtype} "
                  f"attn={cfg.attn_impl} {arm}: p{t['p']} data{t['data']} B "
                  f"{t['batch']} x {t['seq']} in m {t['m']} of {mb}; steps (slowest "
                  f"rank) {' / '.join(f'{1e3 * x:.2f}' for x in slowest)} ms, median "
                  f"{1e3 * step_s:.2f} ms, {tokens / step_s:.1f} tokens/s; losses "
                  f"{' / '.join(f'{x:.6f}' for x in rs[0]['losses'])}; "
                  f"max_memory_allocated per rank "
                  f"{[round(r['peak'] / 2**30, 2) for r in rs]} GiB; flash launches per "
                  f"rank {[r['counts'] for r in rs]} (rope's among them); per step (ops, bytes): "
                  f"collective-permute {sorted(cp)} ({hop} B a hop), all-reduce "
                  f"{sorted(ar)}; ms in collectives per rank, last step {in_coll}; "
                  f"transport {ranks[0]['transport']} ({SPMD_TRANSPORT}); "
                  f"{world} ranks in {wall:.1f} s; card {smi}")
            print(f"[check] spmd {arm}: hops per step {n_hops} = 2(m + p - 1) - 1"
                  f"{' + 2(m + p - 1)' if arm == 'bpipe' else ''} on every rank and "
                  f"step, {hop} B each {ok_hops}; flash launches per rank "
                  f"{want_counts} = (2, 1, 1) x (m + p - 1) x layers/p x steps, "
                  f"rope's (2, 1) x the same "
                  f"{ok_counts}; one loss on every rank {ok_loss}")
        same = all(r["same"] for r in ranks)
        ok_ref, loss_err, rel, worst = spmd_ref_check(ranks, ref_grads)
        del ref_grads
        torch.cuda.empty_cache()
        loss = ranks[0]["arms"]["bpipe"]["losses"][-1]
        print(f"[check] spmd remat and bpipe last loss and every grad leaf bit-equal "
              f"on every rank {same}; bpipe last loss {loss:.6f} vs the single-device "
              f"reference {ref_loss:.6f} (err {loss_err:.3e}, tol {SPMD_LOSS_TOL}), "
              f"grad leaves elementwise max |got - want| / max |want| {rel:.3e} "
              f"({worst}; tol {SPMD_GRAD_RTOL}) {'ok' if same and ok_ref else 'FAIL'}")
        ok = ok and same and ok_ref
        # the same program small in fp32: the card against the CPU
        small = {dv: run_ranks(spmd_rank, SPMD_SMALL["data"] * SPMD_SMALL["p"],
                               args=(SPMD_SMALL, dv, "cpu"), timeout_s=SPMD_TIMEOUT_S,
                               staged_key="CUDA")
                 for dv in ("cuda", "cpu")}
        for arm in SPMD_ARMS:
            errs = [0.0]
            for rc, rp in zip(small["cuda"], small["cpu"]):
                a, b = rc["arms"][arm], rp["arms"][arm]
                errs.append(abs(a["losses"][-1] - b["losses"][-1]))
                errs += [float(abs(a["grads"][k] - b["grads"][k]).max()) for k in b["grads"]]
            small_ok = max(errs) <= 1e-5 and all(r["same"] for r in small["cuda"])
            print(f"[check] spmd {arm} small fp32 (reduced llama-65b, {SPMD_SMALL['layers']} "
                  f"layers, p {SPMD_SMALL['p']}, B {SPMD_SMALL['batch']} x "
                  f"{SPMD_SMALL['seq']}): four ranks on the card vs four on the CPU, "
                  f"loss and grads max_abs_err {max(errs):.3e} (tol 1e-5) "
                  f"{'ok' if small_ok else 'FAIL'}")
            ok = ok and small_ok
        log, _ = dry.communicate(timeout=SPMD_TIMEOUT_S)
    finally:
        dry.kill()
    lines = [ln for ln in log.splitlines() if ln.startswith(("OK pipeline", "FAIL pipeline"))]
    for ln in lines:
        print(f"[dryrun] {ln}")
    dry_ok = dry.returncode == 0 and len(lines) == 4 and all(
        ln.startswith("OK") for ln in lines)
    for arch in ("gpt3-96b", "llama-65b"):
        recs = {}
        for v in ("1f1b", "bpipe"):
            path = os.path.join(dry_dir, f"pipeline__{arch}__single__{v}.json")
            if os.path.exists(path):
                with open(path) as f:
                    recs[v] = json.load(f)
        if len(recs) < 2:
            dry_ok = False
            continue
        ticks = recs["1f1b"]["ticks"]
        diff = recs["bpipe"]["collective_permute_ops"] - recs["1f1b"]["collective_permute_ops"]
        good = (recs["1f1b"]["collective_permute_ops"] == spmd_hops(
            recs["1f1b"]["num_micro"], recs["1f1b"]["p"], False) and diff == 2 * ticks)
        print(f"[check] dry run {arch} single: permutes per step 1f1b "
              f"{recs['1f1b']['collective_permute_ops']}, bpipe "
              f"{recs['bpipe']['collective_permute_ops']} (2 x {ticks} ticks more) "
              f"{'ok' if good else 'FAIL'}")
        dry_ok = dry_ok and good
    shutil.rmtree(dry_dir, ignore_errors=True)
    if not (ok and dry_ok):
        fail("the SPMD pipeline's hops, launches, arms, reference, card-vs-CPU or "
             "dry run are wrong")
    return counts_by_arm


def sharded_tcfg(t):
    from repro_torch.configs.base import TrainConfig
    return TrainConfig(global_batch=t["batch"], seq_len=t["seq"], remat="none")


def sharded_batch(torch, dev, cfg, t):
    from repro_torch.data.pipeline import DataConfig, make_batch
    return {k: torch.from_numpy(v).to(dev) for k, v in make_batch(
        cfg, DataConfig(batch=t["batch"], seq_len=t["seq"]), 0).items()}


def sharded_flash_launches(layers, steps):
    """Each flash kernel's launches a rank over ``steps`` steps at remat
    none: every attention layer forward once and backward once a step."""
    n = layers * steps
    return {"flash_attention_fwd": n, "flash_attention_dq": n,
            "flash_attention_dkv": n}


def sharded_cfg(t):
    """The config of a phase 15 row ``t``: its arch and depth, flash, at full
    width or reduced, fp32 where ``t["fp32"]``."""
    from repro_torch import serve
    cfg = serve.config_for(t["arch"], layers=t["layers"], attn_impl="flash",
                           reduced=t["reduced"])
    return dataclasses.replace(cfg, dtype="float32") if t.get("fp32") else cfg


@contextlib.contextmanager
def expert_choices(torch, into):
    """Inside the block each MoE layer's router appends its tokens' expert
    choices (sorted, int16, a numpy array: a spawned rank hands it back by
    value) to ``into``, in call order."""
    from repro_torch.models import moe
    route = moe._route

    def spy(router, x, cfg):
        out = route(router, x, cfg)
        into.append(out[1].sort(-1).values.to(torch.int16).cpu().numpy())
        return out

    moe._route = spy
    try:
        yield into
    finally:
        moe._route = route


def routing_flips(got, want):
    """Tokens whose set of expert choices differs between two runs, summed
    over the MoE layers (each run's choices from ``expert_choices``)."""
    return int(sum((g != w).any(-1).sum() for g, w in zip(got, want)))


def sharded_reference(torch, dev, cfg, t, routes=None):
    """The single-device train step (``make_train_step(cfg, tcfg)``, no mesh)
    on the params every rank draws (seed 0) and the batch of step 0: its
    loss, and its grads and updated params keyed by path. ``routes``, a
    list, takes the grads' forward's expert choices."""
    from repro_torch import tree as T
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    from repro_torch.train.steps import make_loss_grad, make_train_step
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    batch = sharded_batch(torch, dev, cfg, t)
    with expert_choices(torch, [] if routes is None else routes):
        _, grads = make_loss_grad(cfg, sharded_tcfg(t))(params, batch)
    params, opt, metrics = make_train_step(cfg, sharded_tcfg(t))(
        params, adam.init(params), batch)
    del opt, batch
    name = lambda p: "/".join(map(str, p))
    return (float(metrics["total"]),
            {name(p): g for p, g in T.leaves_with_paths(grads)},
            {name(p): x for p, x in T.leaves_with_paths(params)})


def sharded_errs(torch, tree, want, mesh):
    """Each local shard of DTensor ``tree`` against the slice of the
    reference's full tensor it holds: {path: (max |got - want| / max |want|,
    whether every element is within the fp32 bars)}."""
    from repro_torch import tree as T
    from repro_torch.sharding import rules
    out = {}
    for path, x in T.leaves_with_paths(tree):
        key = "/".join(map(str, path))
        w = want[key][rules.local_slices(x.shape, mesh, x.placements)].to(x.device)
        got = x.to_local()
        diff = (got - w).abs()
        out[key] = (float(diff.max() / w.abs().max().clamp_min(1e-30)),
                    bool((diff <= SHARDED_FP32_ATOL + SHARDED_FP32_RTOL * w.abs()).all()))
        del w, got, diff
    return out


def sharded_rank(rank, world, t, device, refs, fault=False):
    """Phase 15 on one rank (spawned by ``launch.ranks.run_ranks``): the
    sharded train step of ``t``'s model on a (data, model) mesh of the ranks,
    params drawn on ``device`` from seed 0 by one rank at a time (each keeps
    its shards), the batch of step 0. With ``refs["small"]`` it first runs
    one step of ``SHARDED_SMALL`` in fp32 against that reference. Then the
    grads of the drawn params (``make_loss_grad`` on the mesh) and
    ``t["steps"]`` steps, each timed on this rank (a barrier before, a
    synchronise after), the flash counts set to 0 just before the steps and
    read just after, the collective counter read each step; the grads and
    the first step's loss and updated params are held to ``refs["full"]``
    (the parent's, shared over CUDA IPC) slice by slice. ``fault`` rolls rank 1's local
    ``wq`` shard by one head before the steps (a planted fault the bars must
    catch)."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch import staged
    from repro_torch.models import model as M
    from repro_torch.optim import adam
    from repro_torch.pipeline import collectives as C
    from repro_torch.sharding import rules
    from repro_torch.train.steps import make_loss_grad, make_train_step

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(t["data"], t["model"], dev.type)
    out = {"rank": rank, "coords": [mesh.get_local_rank(n) for n in ("data", "model")],
           "transport": staged.TRANSPORT if cuda else "gloo (CPU tensors)"}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def draw(cfg, tt, serial):
        """(DTensor params, shardings' placements, DTensor batch)."""
        batch = sharded_batch(torch, dev, cfg, tt)
        dparams = ps = None
        for r in range(world) if serial else (rank,):
            if r == rank:
                full = M.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
                ps, _, bs = make_train_step(cfg, sharded_tcfg(tt), mesh)[1](full, None, batch)
                dparams = rules.distribute(full, mesh, ps)
                del full
                if cuda:
                    torch.cuda.empty_cache()
            if serial:
                dist.barrier()
        return dparams, rules.distribute(batch, mesh, bs)

    if "small" in refs:
        small = dict(t.get("small", SHARDED_SMALL), data=t["data"], model=t["model"])
        cfg = sharded_cfg(small)
        dparams, dbatch = draw(cfg, small, serial=False)
        loss, grads, params = refs["small"]
        with expert_choices(torch, []) as routes:
            _, g = make_loss_grad(cfg, sharded_tcfg(small), mesh)(dparams, dbatch)
        out["small"] = {"grads": sharded_errs(torch, g, grads, mesh),
                        "routes": routes if rank == 0 else None}
        step, _ = make_train_step(cfg, sharded_tcfg(small), mesh)
        new, _, m = step(dparams, adam.init(dparams), dbatch)
        out["small"].update(loss_err=abs(float(m["total"].full_tensor()) - loss),
                            params=sharded_errs(torch, new, params, mesh))
        grads.clear()  # the parent's tensors, released at once
        params.clear()
        del dparams, dbatch, new, m, g, step

    cfg = sharded_cfg(t)
    rules.RELOCATIONS.clear()
    rules.REDISTRIBUTIONS.clear()
    dparams, dbatch = draw(cfg, t, serial=True)
    if fault and rank == 1:
        wq = dparams["blocks"]["pos0"]["mixer"]["wq"].to_local()
        wq.copy_(torch.roll(wq, 1, dims=2))  # (layers, d, local heads, hd)
    opt = adam.init(dparams)
    loss, grads, params = refs["full"]
    # the grads of step 0's params, held to the reference's and let go of
    # before the steps (the parent's memory too, now, not at exit)
    with expert_choices(torch, []) as routes:
        _, g = make_loss_grad(cfg, sharded_tcfg(t), mesh)(dparams, dbatch)
    out["grads"] = sharded_errs(torch, g, grads, mesh)
    out["routes"] = routes if rank == 0 else None
    grads.clear()
    del g
    step, _ = make_train_step(cfg, sharded_tcfg(t), mesh)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    counts_zero(fa)
    times, losses, counters = [], [], []
    for i in range(t["steps"]):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        C.reset()
        dparams, opt, m = step(dparams, opt, dbatch)
        sync()
        times.append(time.perf_counter() - t0)
        counters.append(C.read())
        losses.append(float(m["total"].full_tensor()))
        if i == 0:
            out["loss_err"] = abs(losses[0] - loss) / abs(loss)
            out["params"] = sharded_errs(torch, dparams, params, mesh)
            params.clear()
        del m
    out.update(times=times, losses=losses, counters=counters, counts=counts_read(fa),
               peak=torch.cuda.max_memory_allocated() if cuda else None,
               relocations=sorted({(tag, d, -1 if d2 is None else d2)
                                   for tag, _, d, d2, _ in rules.RELOCATIONS}),
               moves=[[str(x) for x in e] for e in rules.REDISTRIBUTIONS])
    return out


def sharded_check(ranks, want_keys):
    """Phase 15's bf16 bars over every rank: (ok, the worst loss error
    (relative), the worst leaf's error and key). Every leaf of the reference
    must be checked on some rank, grads and updated params."""
    errs = {f"{kind} {k}": v[0] for r in ranks for kind in ("grads", "params")
            for k, v in r[kind].items()}
    loss_err = max(r["loss_err"] for r in ranks)
    worst, key = max((v, k) for k, v in errs.items())
    ok = (set(errs) == {f"{kind} {k}" for kind in ("grads", "params") for k in want_keys}
          and loss_err <= SHARDED_LOSS_RTOL and worst <= SHARDED_RTOL)
    return ok, loss_err, worst, key


def sharded_small_check(ranks):
    """The fp32 bars of the small step: (ok, loss error, worst leaf's max
    |got - want| / max |want|)."""
    loss_err = max(r["small"]["loss_err"] for r in ranks)
    leaves = [v for r in ranks for kind in ("grads", "params")
              for v in r["small"][kind].values()]
    ok = loss_err <= SHARDED_FP32_LOSS and all(
        within for _, within in leaves)
    return ok, loss_err, max(v for v, _ in leaves)


def sharded_phase(torch, dev, smi):
    """Phase 15: the sharded train step on four ranks of the one card, one
    spawn a row of ``SHARDED``. Returns each row's flash launch counts
    summed over the ranks."""
    import statistics

    from repro_torch.launch.ranks import run_ranks

    counts_by_row, ok = {}, True
    for arch, data, model, layers in SHARDED["rows"]:
        t = dict(SHARDED, arch=arch, data=data, model=model, layers=layers)
        small_t = SHARDED_FP32_FULL if arch == SHARDED_FP32_FULL["arch"] else SHARDED_SMALL
        t["small"] = small_t
        world = data * model
        cfg = sharded_cfg(t)
        t0 = t_row = time.perf_counter()
        routes = []
        loss, grads, params = sharded_reference(torch, dev, cfg, t, routes)
        keys = sorted(grads)
        # through the host and back, so the kept tensors lie in blocks of
        # their own and none holds the reference's freed activations reserved
        grads = {k: g.cpu() for k, g in grads.items()}
        params = {k: x.cpu() for k, x in params.items()}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        grads = {k: g.to(dev) for k, g in grads.items()}
        params = {k: x.to(dev) for k, x in params.items()}
        small_routes = []
        small = sharded_reference(torch, dev, sharded_cfg(small_t), small_t,
                                  small_routes)
        print(f"[sharded] {arch} mesh ({data}, {model}): the single-device "
              f"reference ({layers} layers) in {time.perf_counter() - t0:.1f} s, the "
              f"parent holding its grads and updated params: memory_allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB")
        t0 = time.perf_counter()
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            ranks = run_ranks(sharded_rank, world, args=(
                t, "cuda", {"full": (loss, grads, params), "small": small}),
                timeout_s=SHARDED_TIMEOUT_S, staged_key="CUDA")
        finally:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        wall = time.perf_counter() - t0
        row_s = time.perf_counter() - t_row
        del grads, params, small
        torch.cuda.empty_cache()
        slowest = [max(r["times"][i] for r in ranks) for i in range(t["steps"])]
        step_s = statistics.median(slowest)
        tokens = t["batch"] * t["seq"]
        want_counts = sharded_flash_launches(layers, t["steps"])
        want_counts.update(rope_launches(want_counts))
        ok_counts = all(r["counts"] == want_counts for r in ranks)
        ok_loss = len({tuple(r["losses"]) for r in ranks}) == 1
        coll = sorted({(k, c["ops"][k], int(c["bytes"][k])) for r in ranks
                       for c in r["counters"] for k in c["ops"] if c["ops"][k]})
        in_coll = [round(sum(r["counters"][-1]["seconds"].values()) * 1e3, 1)
                   for r in ranks]
        ok_ref, loss_err, worst, key = sharded_check(ranks, keys)
        ok_small, small_loss, small_worst = sharded_small_check(ranks)
        flips = routing_flips(ranks[0]["routes"], routes)
        small_flips = routing_flips(ranks[0]["small"]["routes"], small_routes)
        routed = sum(int(r[..., 0].size) for r in routes)
        ok = ok and ok_counts and ok_loss and ok_ref and ok_small
        counts_by_row[f"{arch} ({data}, {model})"] = {
            k: sum(r["counts"][k] for r in ranks) for k in want_counts}
        print(f"[sharded] {cfg.name} {layers} layers d{cfg.d_model} {cfg.num_heads}/"
              f"{cfg.num_kv_heads}x{cfg.head_dim} ff{cfg.d_ff} vocab {cfg.vocab_size} "
              f"{cfg.dtype} attn={cfg.attn_impl} mesh "
              f"(data {data}, model {model}): B {t['batch']} x {t['seq']}; steps "
              f"(slowest rank) {' / '.join(f'{1e3 * x:.2f}' for x in slowest)} ms, "
              f"median {1e3 * step_s:.2f} ms, {tokens / step_s:.1f} tokens/s; losses "
              f"{' / '.join(f'{x:.6f}' for x in ranks[0]['losses'])}; "
              f"max_memory_allocated per rank "
              f"{[round(r['peak'] / 2**30, 2) for r in ranks]} GiB; flash and rope launches "
              f"per rank {[r['counts'] for r in ranks]}; collectives a step (kind, ops, "
              f"bytes) {coll}; ms in collectives per rank, last step {in_coll}; "
              f"relocations {ranks[0]['relocations']}; the model's local-tensor moves "
              f"(q/k/v before flash among them) {ranks[0]['moves']}; transport {ranks[0]['transport']} "
              f"(4 ranks share one card: the times say nothing of NVLink); {world} "
              f"ranks in {wall:.1f} s; the row (reference and ranks) in {row_s:.1f} s; "
              f"card {smi}")
        print(f"[check] sharded {arch} ({data}, {model}): loss vs the single-device "
              f"step relative err {loss_err:.3e} (tol {SHARDED_LOSS_RTOL}); grads and "
              f"updated params, each rank's slice, max |got - want| / max |want| "
              f"{worst:.3e} ({key}; tol {SHARDED_RTOL}) {'ok' if ok_ref else 'FAIL'}"
              + (f"; tokens whose expert choices differ from the single-device "
                 f"step's, over {len(routes)} MoE layers: {flips} of {routed}"
                 if routes else "")
              + f"; fp32 {small_t['arch']} ({small_t['layers']} layers, "
              f"{'reduced' if small_t['reduced'] else 'full width'}, B "
              f"{small_t['batch']} x {small_t['seq']}) loss err "
              f"{small_loss:.3e} (tol {SHARDED_FP32_LOSS}), worst leaf {small_worst:.3e}, "
              f"every element within {SHARDED_FP32_ATOL} + {SHARDED_FP32_RTOL}|want| "
              f"{'ok' if ok_small else 'FAIL'}"
              + (f", expert choices differing {small_flips}" if small_routes else "")
              + f"; flash and rope launches per rank "
              f"{want_counts} = layers x steps {ok_counts}; one loss on every rank "
              f"{ok_loss}")
    if not ok:
        fail("the sharded train step's launches, losses or bars against the "
             "single-device step are wrong")
    return counts_by_row


def n_attn(fam, path):
    """The attention layers of the family's config at ``path``'s depth: each
    flash kernel's launches a pass."""
    from repro_torch import serve
    return len(attn_keys(serve.config_for(fam["arch"], layers=fam[path]["layers"]), 1))


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
               "flash_attention_dkv", "fused_softmax_fwd", "fused_softmax_bwd",
               "rope"]
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

    # -- 16. the rope kernel, first: the profiler of this process has shown no
    # device time for it after phase 13's profiles; its own generator, so that
    # the later phases draw what they drew before ---------------------------------
    rope_row = rope_phase(torch, dev, torch.Generator(dev).manual_seed(0), smi)

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
    cases += [dict(b=b, sq=sq, sk=sk, nq=nq, nkv=nkv, hd=hd, dtype="bfloat16",
                   window=0, softcap=0.0, q_offset=off, name="sliced full width")
              for b, sq, sk, nq, nkv, hd, off in SLICED]
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
    bwd_cases += [c for c in cases if c["name"] in ("q_offset", "strided", "sm90",
                                                    "sliced full width")]
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
    # the three kernels at the sequence-sliced path's full-width shapes
    sliced_times = sliced_kernel_times(torch, F, fa, ref, qkv, gen, dev, smi)

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
    pipe, params, batches = pipeline_path(torch, dev, smi)

    # -- 12. the sequence-sliced pipelined step, on phase 9's params and batches ----------
    sliced_counts = sliced_path(torch, dev, smi, params, batches, pipe["1f1b"])
    del params, batches
    torch.cuda.empty_cache()

    # -- 10. is the pipelined path right ---------------------------------------------------
    pipeline_checks(torch, dev)

    # -- 11. the estimation path: stage gains, audits, --plan auto ------------------------
    estimate_counts = estimation_phase(torch, dev, smi)

    # -- 13. the other families (MoE, RG-LRU, xLSTM, enc-dec, VLM) and head_dim 256 --------
    (timed_rows, fam_err), family_counts = families_phase(
        torch, F, fa, ref, qkv, gen, dev, smi)
    hd256_row = timed_rows[HD256[0][7]]

    # -- 14. the SPMD pipeline: four gloo ranks on the one card ----------------------------
    spmd_counts = spmd_phase(torch, dev, smi)

    # -- 15. the sharded train step: four ranks on the one card, two meshes ----------------
    sharded_counts = sharded_phase(torch, dev, smi)
    family_rows = [row for label, row in timed_rows.items() if label != HD256[0][7]]

    def by_path(name):
        return {"serve": serve_counts.get(name, 0), "train": train_counts.get(name, 0),
                **{f"pipeline {kind}": arm["counts"][name] for kind, arm in pipe.items()},
                **{f"sliced pipeline {label}": c[name]
                   for label, c in sliced_counts.items()},
                **{path: c[name] for path, c in estimate_counts.items()},
                **{path: c[name] for path, c in family_counts.items()},
                **{f"spmd {arm}": c[name] for arm, c in spmd_counts.items()},
                **{f"sharded {mesh}": c[name] for mesh, c in sharded_counts.items()}}

    def launches(name):  # this slice's main path: phase 15, every row, all ranks
        return sum(c[name] for c in sharded_counts.values())

    def at_family_shapes(name):
        return [row[name] for row in family_rows]

    # every path's rope launches, read from its own run: at least its flash
    # launches, so no rotary embedding beside a flash call left the kernel
    keys = (*FLASH_KEYS, "rope_fwd", "rope_bwd")
    table = {k: by_path(k) for k in keys}
    rows = {path: {k: table[k][path] for k in keys} for path in table["rope_fwd"]}
    short = rope_short(rows)
    print(f"[check] rope launches by path (forward, backward): "
          f"{ {path: (c['rope_fwd'], c['rope_bwd']) for path, c in rows.items()} }; "
          f"each at least the path's flash forward and dq launches "
          f"{'ok' if not short else 'FAIL: ' + str(short)}")
    if short:
        fail("a path ran fewer rope kernel launches than flash launches")
    rope_row["launches"] = {k: launches(k) for k in ("rope_fwd", "rope_bwd")}
    rope_row["launches_by_path"].update(
        {path: {k: c[k] for k in ("rope_fwd", "rope_bwd")} for path, c in rows.items()})

    def at_sliced_shapes(name):
        return [{"shape": row["shape"], **row[name]} for row in sliced_times]

    print(json.dumps({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_fwd_sm90.cu",
         "fp32_source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "sass": sass.get("flash_attention_fwd_sm90"),
         "replaces": "src/repro/kernels/flash_attention.py:31",
         "launches": launches("flash_attention_fwd"),
         "launches_by_path": by_path("flash_attention_fwd"),
         "at_sliced_shapes": at_sliced_shapes("flash_attention_fwd"),
         "at_head_dim_256": hd256_row["flash_attention_fwd"],
         "at_family_shapes": at_family_shapes("flash_attention_fwd"),
         "max_abs_err": max(max_err, fam_err["flash_attention_fwd"]),
         "ms": kernel_ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{source}.cu",
         **({"fp32_source": f"src/repro_torch/kernels/csrc/{name}.cu",
             "sass": sass.get(source)} if source != name else {}),
         "replaces": f"src/repro/kernels/flash_attention.py:{line}",
         "launches": launches(name),
         "launches_by_path": by_path(name),
         "at_sliced_shapes": at_sliced_shapes(name),
         "at_head_dim_256": hd256_row[name],
         "at_family_shapes": at_family_shapes(name),
         "max_abs_err": max(bwd_err[name], fam_err[name]), "ms": bwd_ms_by[name],
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
        for name, line in (("fused_softmax_fwd", 22), ("fused_softmax_bwd", 35))]
        + [rope_row]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
