"""flash_roofline: the least time of the flash kernels' launches in the
traced window over their summed device time, in %. Each launch is one
layer of one microbatch: q (b, s, nq, hd), k and v (b, s, nkv, hd) in the
model's dtype; its least time is ``bench/flops.py``'s bound (the larger of
FLOPs over the bf16 peak and bytes over HBM bandwidth, causal pairs only,
each input byte read once). None where no flash kernel ran."""
from bench import flops

KERNELS = {"fwd": ("flash_fwd_sm90_kernel", "flash_fwd_fma_kernel"),
           "dq": ("flash_dq_sm90_kernel", "flash_dq_fma_kernel"),
           "dkv": ("flash_dkv_sm90_kernel", "flash_dkv_fma_kernel")}


def read(ctx):
    m, tr = ctx.model, ctx.traffic
    shape = (int(tr["micro_batch"]), int(tr["seq_len"]), int(tr["seq_len"]),
             m["num_heads"], m["num_kv_heads"], flops.head_dim(m),
             2 if m.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4)
    least = {"fwd": flops.attention_bound(*shape)[0]}
    least.update({k: v[0] for k, v in flops.bwd_bounds(*shape).items()})
    bound = spent = 0.0
    for name, (count, seconds) in ctx.trace.op_totals().items():
        for kernel, marks in KERNELS.items():
            if any(mark in name for mark in marks):
                bound += count * least[kernel]
                spent += seconds
    if spent <= 0:
        return None
    return 100.0 * bound / spent
