"""One event stream out of ``plan.run``, the port's copy of the JAX
package's observability layer (each module held equal by
``tests/test_torch_core.py``; so is this file's code):

  * ``events``   -- the canonical ``Span`` schema, the ``Observer`` contract
                    and ``Recorder`` (the one module that builds spans);
  * ``timeline`` -- the ordered per-stage / per-channel view;
  * ``metrics``  -- bubble fractions, stalls, channel occupancy, MFU, HBM
                    residency timelines;
  * ``export``   -- the Perfetto/Chrome exporter (lossless round trip);
  * ``compare``  -- sim-vs-real divergence reports (``audit``, which runs
                    the executor, is ``planner.measure.audit``).
"""
from repro_torch.obs.events import (CHANNEL, COMPUTE, ISSUE, WAIT, Observer,
                              Recorder, Span)
from repro_torch.obs.timeline import Timeline

__all__ = ["CHANNEL", "COMPUTE", "ISSUE", "WAIT", "Observer", "Recorder",
           "Span", "Timeline"]
