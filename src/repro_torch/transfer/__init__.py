"""Transfers of stash units: the per-device channels that residency moves
(EVICT/LOAD, OFFLOAD/FETCH) ride, each admitting a bounded number of copies
in flight (``ScheduleSpec.depth``).

  * ``channel`` -- channel keys and the serialized FIFO pricing model, shared
    by the simulator and the executor;
  * ``engine``  -- ``TransferEngine``: the simulator's channel set for one
    compiled schedule, pricing every registered policy's moves;
  * ``runtime`` -- the executor's bounded-depth tracking of its real copies
    on CUDA events (imported by the executor, not here).

``channel`` and ``engine`` are copies of the JAX package's modules, held
equal by ``tests/test_torch_core.py``; so is this file's code.
"""
from repro_torch.transfer.channel import (D2H, H2D, PEER, Channel, ChannelStats,
                                    channel_key)
from repro_torch.transfer.engine import TransferEngine

__all__ = ["Channel", "ChannelStats", "TransferEngine", "channel_key",
           "PEER", "D2H", "H2D"]
