"""Roofline terms of the port's pipelined step: the twin of the JAX
package's ``repro/launch/roofline.py``, at H100 constants.

Three terms per (arch x shape x mesh), in seconds (``core/h100.py``):

    compute    = FLOPs / 989 TFLOP/s        (bf16 dense)
    memory     = HBM bytes / 3.35 TB/s
    collective = collective bytes / 450 GB/s (NVLink 4, one direction)

Where the JAX twin parses the collective ops' operand sizes out of
``compiled.as_text()``, ``collective_bytes`` here reads the port's
collective counter (``pipeline/collectives.py``): the bytes of every op a
rank ran since the counter's last reset. The twin counts the ops of a
compiled program once (a ``lax.scan`` body is one op per tick kind); the
counter counts the ops a step runs.

``extrapolate`` is the twin's: total = base + per_block x n_blocks from
1- and 2-block runs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.h100 import H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_BF16
from repro_torch.pipeline import collectives

COLLECTIVES = collectives.KINDS


def collective_bytes() -> Dict[str, float]:
    """Per-collective-kind output bytes this rank moved since the counter's
    last reset."""
    return collectives.read()["bytes"]


@dataclasses.dataclass
class RooflineTerms:
    flops: float            # per device
    bytes_hbm: float        # per device
    bytes_collective: float  # per device
    chips: int

    @property
    def t_compute(self) -> float:
        return self.flops / H100_PEAK_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / H100_HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_collective / H100_NVLINK_BW

    @property
    def dominant(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Optimistic (perfect-overlap) step time = max of the three."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def mfu(self, model_flops_per_device: float) -> float:
        return model_flops_per_device / (self.step_time * H100_PEAK_BF16)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "bytes_hbm": self.bytes_hbm,
            "bytes_collective": self.bytes_collective, "chips": self.chips,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
        }


def extrapolate(cost1: Dict, cost2: Dict, n_blocks: int) -> Dict:
    """total = base + per_block * n_blocks from 1- and 2-block unrolled runs."""
    out = {}
    keys = set(cost1) | set(cost2)
    for k in keys:
        c1, c2 = cost1.get(k, 0.0), cost2.get(k, 0.0)
        per_block = max(c2 - c1, 0.0)
        base = max(c1 - per_block, 0.0)
        out[k] = base + per_block * n_blocks
    return out
