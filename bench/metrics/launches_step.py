"""launches_step: the device operations of the traced window (kernels,
copies and fills, as ``bench/trace.py`` counts them) over the number of
``pipe.step`` ranges in it: the launches the host issues a step. None where
the trace holds no ``pipe.step`` range."""
from bench import ranges


def read(ctx):
    steps = sum(e.name == ranges.STEP for e in ctx.trace.host)
    if not steps:
        return None
    return len(ctx.trace.ops) / steps
