"""idle_interp_pct: the share of the traced window in which the device was
idle while the host was inside the program's range ``pipe.step`` but in
none of ``pipe.F``, ``pipe.RECOMPUTE`` and ``pipe.B``: the executor's ready
loop, its store and moves, the parameter split, the grad merge and the
loss, in %. None where the trace holds no ``pipe.step`` range
(``bench/ranges.py``). Logs the whole split, with the idle time outside any
step (the benchmark's synchronise and its pick of a batch), on standard
error, in % of the window and in ms a traced step: the four parts add up
to ``device_idle_pct``."""
import sys

from bench import ranges

PARTS = ("fwd", "bwd", "interp", "outside", "idle")


def read(ctx):
    us = ranges.idle_us(ctx.trace)
    if us is None:
        return None
    pct = ranges.idle_split(ctx.trace)
    steps = max(us["steps"], 1)
    print("[bench] device idle, % of the traced window: "
          + ", ".join(f"{k} {pct[k]:.3f}" for k in PARTS)
          + f"; ms a step over {us['steps']} steps: "
          + ", ".join(f"{k} {us[k] / 1e3 / steps:.3f}" for k in PARTS),
          file=sys.stderr, flush=True)
    return pct["interp"]
