"""device_idle_pct: the share of the traced window in which no operation
ran on the device (kernels, copies and fills; the profiler's range
annotations are not operations). Where the host paces the step, the
profiler's own cost on the host lengthens the window, so this reads
higher than an untraced run's idle share would."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
