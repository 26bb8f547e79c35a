"""idle_fwd_pct: the share of the traced window in which the device was
idle while the host was inside the program's range ``pipe.F`` or
``pipe.RECOMPUTE`` (a stage's forward, run by the executor's main thread),
in %. None where the trace holds no ``pipe.step`` range
(``bench/ranges.py``)."""
from bench import ranges


def read(ctx):
    split = ranges.idle_split(ctx.trace)
    return None if split is None else split["fwd"]
