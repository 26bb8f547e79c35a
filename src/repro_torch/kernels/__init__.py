"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:

  flash_attention.py — flash-attention-2 forward with an online softmax,
    GQA in the tile, causal/window/kv-padding/q_offset masks, softcap and
    whole-tile skipping; LSE output. Its two-pass backward: dq and dk/dv
    (csrc/flash_attention_dkv.cu), P recomputed from the LSE, one block per
    output tile (no atomics), the same masks and tile skipping. The forward
    and dq have two routes by dtype: bf16 runs csrc/flash_attention_fwd_sm90.cu
    and csrc/flash_attention_dq_sm90.cu (wgmma on bf16 tiles, TMA into an
    mbarrier ring; shared pieces in csrc/hopper.cuh), fp32 runs the exact
    fp32 FMA kernels csrc/flash_attention_fwd.cu and csrc/flash_attention_dq.cu.
  fused_softmax.py — fused scale-mask-softmax forward (csrc/fused_softmax_fwd.cu:
    online max and sum per row, then the normalised write) and backward
    (csrc/fused_softmax_bwd.cu: the row's sum of y dy, then dx).

ops.py = autograd wrappers; ref.py = plain-torch oracles; build.py = nvcc
build at first use + ctypes loading.
"""
