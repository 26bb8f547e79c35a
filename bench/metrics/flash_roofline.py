"""flash_roofline: the least time of the flash kernels' launches in the
traced window over their summed device time, in %. Each launch is one
layer of one microbatch: q (b, s, nq, hd), k and v (b, s, nkv, hd) in the
model's dtype; its least time is ``bench/flops.py``'s bound (the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth, kept pairs only,
each input byte read once), averaged over the model's attention layers:
a ``local_attn`` layer at its ``window_size``, an ``attn`` layer causal
over the whole sequence (``flops._kinds``). None where no flash kernel
ran."""
from bench import flops

KERNELS = {"fwd": ("flash_fwd_sm90_kernel", "flash_fwd_fma_kernel"),
           "dq": ("flash_dq_sm90_kernel", "flash_dq_fma_kernel"),
           "dkv": ("flash_dkv_sm90_kernel", "flash_dkv_fma_kernel")}


def read(ctx):
    m, tr = ctx.model, ctx.traffic
    shape = (int(tr["micro_batch"]), int(tr["seq_len"]), int(tr["seq_len"]),
             m["num_heads"], m["num_kv_heads"], flops.head_dim(m),
             2 if m.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4)
    kinds = [k for k in flops._kinds(m) if k in ("attn", "local_attn")]
    least = dict.fromkeys(KERNELS, 0.0)  # seconds of one launch
    for kind in dict.fromkeys(kinds):
        window = m.get("window_size", 0) if kind == "local_attn" else 0
        weight = kinds.count(kind) / len(kinds)
        least["fwd"] += weight * flops.attention_bound(*shape, window=window)[0]
        for k, v in flops.bwd_bounds(*shape, window=window).items():
            least[k] += weight * v[0]
    bound = spent = 0.0
    for name, (count, seconds) in ctx.trace.op_totals().items():
        for kernel, marks in KERNELS.items():
            if any(mark in name for mark in marks):
                bound += count * least[kernel]
                spent += seconds
    if spent <= 0:
        return None
    return 100.0 * bound / spent
