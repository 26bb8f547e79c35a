"""cast_gradsum_pct: the device time of the kernels launched under the
program's ranges ``cast`` (``layers.cast_matmul`` / ``cast_bmm``'s weight
casts, forward and backward) and ``pipe.grad_sum`` (the executor's fp32
grad sums), as a share of the traced window's busy device time, in %: the
profiler's host cost stretches the window, not the busy time. Each
direction opens its own range, so no backward node is charged. None where
neither range ran (``bench/ranges.py``)."""
from bench import ranges


def read(ctx):
    spent = ranges.device_s(ctx.trace, ranges.CAST_GRADSUM)
    if spent <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * spent / ctx.trace.busy_s
