"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version:

  flash_attention.py — flash-attention-2 forward (csrc/flash_attention_fwd.cu)
    with an online softmax, GQA in the tile, causal/window/kv-padding/
    q_offset masks, softcap and whole-tile skipping; LSE output. Its
    two-pass backward: dq (csrc/flash_attention_dq.cu) and dk/dv
    (csrc/flash_attention_dkv.cu), P recomputed from the LSE, one block per
    output tile (no atomics), the same masks and tile skipping.
  fused_softmax.py — fused scale-mask-softmax forward (csrc/fused_softmax_fwd.cu:
    online max and sum per row, then the normalised write) and backward
    (csrc/fused_softmax_bwd.cu: the row's sum of y dy, then dx).

ops.py = autograd wrappers; ref.py = plain-torch oracles; build.py = nvcc
build at first use + ctypes loading.
"""
