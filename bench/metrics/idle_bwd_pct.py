"""idle_bwd_pct: the share of the traced window in which the device was
idle while the host was inside the program's range ``pipe.B``, in %. The
main thread waits in ``torch.autograd.grad`` while the engine's thread
launches the backward, so the idle time is charged to B by time alone.
None where the trace holds no ``pipe.step`` range (``bench/ranges.py``)."""
from bench import ranges


def read(ctx):
    split = ranges.idle_split(ctx.trace)
    return None if split is None else split["bwd"]
