"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:

  flash_attention.py — flash-attention-2 forward with an online softmax,
    GQA in the tile, causal/window/kv-padding/q_offset masks, softcap and
    whole-tile skipping; LSE output. Its two-pass backward: dq and dk/dv,
    P recomputed from the LSE, one block per output tile (no atomics), the
    same masks and tile skipping. Each kernel has two routes by dtype: bf16
    runs csrc/flash_attention_{fwd,dq,dkv}_sm90.cu (wgmma on bf16 tiles,
    TMA into an mbarrier ring; shared pieces in csrc/hopper.cuh), fp32 runs
    the exact fp32 FMA kernels csrc/flash_attention_{fwd,dq,dkv}.cu.
  fused_softmax.py — fused scale-mask-softmax forward (csrc/fused_softmax_fwd.cu:
    a warp a row kept in registers up to 4096 columns, an online block
    kernel past that) and backward (csrc/fused_softmax_bwd.cu: the row's
    sum of y dy, then dx).
  rope.py — the rotary embedding of q and k together, one launch a
    direction (csrc/rope.cu): each (token, i) angle's sincosf once in shared
    memory, shared by all heads, 16-byte accesses; the backward is the
    rotation by the negated angles.

ops.py = autograd wrappers; ref.py = plain-torch oracles; build.py = nvcc
build at first use + ctypes loading.
"""
