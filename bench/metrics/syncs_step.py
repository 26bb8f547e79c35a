"""syncs_step: the host's calls that wait for the device
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the synchronous ``cudaMemcpy``) that start
inside a ``pipe.step`` range, on any thread, over the number of those
ranges: how often a step makes the host drain the device's queue. None
where the trace holds no ``pipe.step`` range."""
from bench import ranges

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


def read(ctx):
    trace = ctx.trace
    steps = sum(e.name == ranges.STEP for e in trace.host)
    if not steps:
        return None
    inside = ranges.intervals(trace, (ranges.STEP,))
    syncs = sum(any(a <= e.time_range.start < b for a, b in inside)
                for e in trace.host if e.name in SYNCS)
    return syncs / steps
