"""The measuring half of calibration: the torch versions of the JAX package's
``planner.calibrate.measure_stage_T`` / ``measure_stage_gain`` and
``obs.compare.audit``, the three functions of those modules that build an
executor (the copies in this package leave them out).

Each runs the port's ``PipelineExecutor`` for two steps: the first is a
warm-up (the kernels' first launches, the allocator's first blocks) and is
discarded, the second is traced and fitted with ``calibrate.fit_trace``.
Params come from ``model.init_params`` and tokens from ``torch.randint``,
each from a ``torch.Generator`` of its own on ``device`` (seeds ``seed`` and
``seed + 1``, as the JAX twins use keys 0 and 1); the compute dtype is the
config's. ``device`` defaults to the card and raises without one.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import simulator as SIM
from repro_torch.core.plan import ScheduleSpec
from repro_torch.models import model as M
from repro_torch.obs.compare import CompareReport, compare
from repro_torch.obs.events import Recorder
from repro_torch.pipeline.executor import PipelineExecutor
from repro_torch.planner import calibrate


def _two_steps(cfg, spec: ScheduleSpec, b: int, seq: int, remat: str,
               device, seed: int):
    """The executor's warm-up step, then its traced step."""
    dev = resolve_device(device)
    ex = PipelineExecutor(cfg, spec, micro_batch=b, remat=remat)
    params = M.init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
    toks = torch.randint(0, cfg.vocab_size, (spec.m * b, seq + 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ex.step(params, batch)                       # warm-up, discarded
    return ex.step(params, batch, trace=True)


def measure_stage_T(cfg, b: int, seq: int = 32, m: int = 2,
                    remat: str = "none", device="cuda", seed: int = 0):
    """Run ONE pipeline stage (p=1, the whole of ``cfg``) for m microbatches
    of size b and return (T, costs): T = median F + median B seconds of the
    traced second step."""
    res = _two_steps(cfg, ScheduleSpec("1f1b", 1, m), b, seq, remat, device,
                     seed)
    costs = calibrate.fit_trace(res.events, v=1, b=b)
    return costs.Tf + costs.Tb, costs


def measure_stage_gain(cfg, bx: int, by: int, seq: int = 32, m: int = 2,
                       remat: str = "none", device="cuda",
                       seed: int = 0) -> dict:
    """The paper's decision procedure, measured: stage gain
    MFU_stage(bx)/MFU_stage(by) = (bx/T(bx)) / (by/T(by)). Compare with
    ``estimator.required_stage_gain`` before writing any BPipe code."""
    Tx, cx = measure_stage_T(cfg, bx, seq, m, remat, device, seed)
    Ty, cy = measure_stage_T(cfg, by, seq, m, remat, device, seed)
    return {"bx": bx, "by": by, "Tx": Tx, "Ty": Ty,
            "gain": (bx / Tx) / (by / Ty),
            "costs_x": cx, "costs_y": cy}


def audit(cfg, spec: ScheduleSpec, micro_batch: int = 1, seq: int = 32,
          t_p2p: float = 0.0, seed: int = 0,
          device="cuda") -> CompareReport:
    """End-to-end audit of one spec on one model config: run the real
    executor traced, fit simulator costs from its trace, simulate the same
    spec under those costs, and compare the two streams."""
    assert spec.bound, f"audit needs a bound spec (m > 0): {spec}"
    res = _two_steps(cfg, spec, micro_batch, seq, "none", device, seed)
    costs = calibrate.fit_trace(res.events, v=spec.v, b=micro_batch,
                                seq_chunks=spec.seq_chunks)
    rec = Recorder()
    SIM.simulate(SIM.SimConfig(spec=spec, Tf=costs.Tf, Tb=costs.Tb,
                               t_p2p=t_p2p,
                               evict_bytes=(costs.t_move or 0.0),
                               pair_bw=1.0 if costs.t_move else float("inf")),
                 observer=rec)
    return compare(rec.spans, res.events, label=spec.label())
