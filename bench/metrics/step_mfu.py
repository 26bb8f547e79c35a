"""step_mfu: the traced steps' model FLOPs (their tokens times the model
module's ``flops_per_token``, no recomputation counted) over the
device's busy seconds in the traced window, as a share of the bf16 peak,
in %. It is the whole step's share of peak while the device works, read
from the trace's device time alone, so the profiler's slowing of the host
does not enter it; the idle time is ``device_idle_pct``'s. No kernel's
roofline share can claim more than this bounds."""
from bench import flops


def read(ctx):
    if ctx.trace.busy_s <= 0 or ctx.tokens <= 0:
        return None
    model_flops = ctx.tokens * ctx.module.flops_per_token(ctx.model,
                                                          int(ctx.traffic["seq_len"]))
    return 100.0 * model_flops / (ctx.trace.busy_s * flops.PEAK_BF16)
