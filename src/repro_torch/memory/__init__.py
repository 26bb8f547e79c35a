"""``repro_torch.memory``: the activation-residency subsystem.

Where a stashed activation lives between its F and its B is an axis
orthogonal to the pipeline-schedule kind. This package owns it:

  * ``policy``    — the ``ResidencyPolicy`` contract, the shared
                    cap-driven ``spill`` rewrite, and the registry that
                    extends the schedule op set (``none``/``bpipe_swap``
                    built in).
  * ``offload``   — ``host_offload``: OFFLOAD/FETCH to host DRAM
                    (a real copy to pinned host memory in the executor, D2H/H2D
                    bandwidth in the simulator).
  * ``recompute`` — ``selective_recompute``: DROP the saved tensors,
                    RECOMPUTE the forward ahead of the backward
                    (FLOPs-costed; bit-identical numerics).
  * ``store``     — the residency-aware ``ActivationStore`` the executor
                    interprets stashes with (per-chunk byte weighting).

See docs/memory.md for the policy contract and how to register one.
"""
from repro_torch.memory import offload, policy, recompute, store
from repro_torch.memory.offload import HOST_OFFLOAD
from repro_torch.memory.policy import (BPIPE_SWAP, NONE, POLICIES, RELEASE_OPS,
                                 RESTORE_OPS, ResidencyPolicy, register,
                                 residency_cap, residency_cap_roof, spill,
                                 unregister)
from repro_torch.memory.recompute import SELECTIVE_RECOMPUTE
from repro_torch.memory.store import ActivationStore, StoreStats

__all__ = [
    "ActivationStore", "BPIPE_SWAP", "HOST_OFFLOAD", "NONE", "POLICIES",
    "RELEASE_OPS", "RESTORE_OPS", "ResidencyPolicy", "SELECTIVE_RECOMPUTE",
    "StoreStats", "offload", "policy", "recompute", "register",
    "residency_cap", "residency_cap_roof", "spill", "store", "unregister",
]
