"""The port's profiler ranges and the clock they share with the executor's
spans (port only; the rest of ``obs`` is the JAX package's copy).

``span(name)`` is ``torch.profiler.record_function(name)`` while a
profiler records and one shared ``contextlib.nullcontext()`` otherwise, so
a range costs one check when nothing records. Every range of the port
opens through it:

  * the executor (``pipeline/executor.py``): ``pipe.step`` around a step,
    ``pipe.split`` around the parameter split and the microbatch slicing,
    ``pipe.<OP>`` around each retired instruction (``pipe.F``, ``pipe.B``,
    ``pipe.EVICT``, ``pipe.LOAD``, ...; a WAIT half is ``pipe.<OP>.wait``),
    ``pipe.grad_sum`` around the fp32 grad accumulation and ``pipe.merge``
    around the unflatten and ``StageSplitter.merge``;
  * the weight casts of ``layers.cast_matmul`` / ``cast_bmm``: ``cast``,
    forward and backward (the backward's on the autograd thread);
  * the rotary embedding of q and k (``layers.rope_qk``): ``rope``,
    forward and, on the kernel's path, backward;
  * the models: ``moe_dispatch``, ``moe_combine``, ``encoder``,
    ``mlstm_chunk``, ``slstm_scan``, ``rglru_scan``.

``now_ns()`` reads the clock the profiler stamps host events with: the
Unix epoch in ns (``time.time_ns``), to which ``torch.profiler`` converts
its own cheap clock. The executor reads it once, at a step's start, as
``StepResult.t0_ns``; its spans stay on the monotonic ``perf_counter``,
relative to that start. So a ``trace=True`` span at ``t0_ns + start``
lands on its ``pipe.<OP>`` range of a trace of the same step (the two
clocks drift by microseconds over a step).
"""
from __future__ import annotations

import contextlib
import time

import torch

NULL = contextlib.nullcontext()
_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else the
    shared null context."""
    if _enabled():
        return torch.profiler.record_function(name)
    return NULL


now_ns = time.time_ns
