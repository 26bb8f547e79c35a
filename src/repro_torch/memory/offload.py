"""``host_offload`` residency: spill stashed activations to host memory.

The twin of the JAX package's ``repro/memory/offload.py``. The
SlimPipe-style alternative to BPipe's partner swap: instead of shipping the
newest held unit to the paired *device*, OFFLOAD copies it to host memory
over the D2H link and FETCH copies it back ahead of the backward. Same
spill discipline (``policy.spill``), same cap formulas — what changes is
the link.

In the JAX package the stash is a vjp closure that ``jax.device_put`` moves
whole. Here the stash is an autograd graph, and what it holds on the device
is the tensors autograd saved for the backward. The executor runs each
forward under ``Box.hooks()``, so those tensors land in the unit's ``Box``
(by storage), and OFFLOAD/FETCH move the box: ``to_host`` copies each
storage to pinned host memory, ``to_device`` copies it back. On the card
both copies run on a side stream with ``non_blocking=True`` and record a
CUDA event in the box (``Box.event``): the transfer runtime's WAIT
synchronises on it, and ``to_device`` makes the compute stream wait for it
before anything reads the tensors. ``record_stream`` keeps each device
source from being reused before its copy is done. A box on the CPU stays
where it is (the copy would be a no-op, as ``device_put`` to the host is on
a CPU-only JAX runtime).

A sequence slice's own KV is packed into its unit's box too (``Box.pack``
outside the hooks), so it moves with the box, and ``Box.read`` gives it
back on the card wherever the box is: a later slice's prefix reads it while
the unit is on the host.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

import torch

from repro_torch.core.schedule import FETCH, OFFLOAD
from repro_torch.memory import policy as respol


class Box:
    """The tensors autograd saves while one stash unit's forward runs.

    They are kept by storage: views of one storage share one slot, so a move
    copies each storage once and frees what the graph held. A tensor whose
    storage is in ``keep`` (the stage's parameters, its input leaves and
    the micro-batch, which the step holds anyway) is saved as it is and
    never moves."""

    def __init__(self, keep: Iterable[torch.Tensor] = ()):
        self.storages: List[Any] = []
        self._slot: Dict[int, int] = {}
        self._keep = {t.untyped_storage().data_ptr() for t in keep}
        self.event = None         # the CUDA event of the last move
        self.home = None          # the card the moved storages came from
        self.stream = None        # the side stream both moves run on, in order
        self.moved: List[int] = []  # slots that to_host moved

    def pack(self, t: torch.Tensor):
        st = t.untyped_storage()
        ptr = st.data_ptr()
        if ptr in self._keep or st.nbytes() == 0:
            return t
        i = self._slot.get(ptr)
        if i is None:
            i = self._slot[ptr] = len(self.storages)
            self.storages.append(st)
        return i, t.dtype, t.storage_offset(), t.size(), t.stride()

    def unpack(self, packed) -> torch.Tensor:
        if isinstance(packed, torch.Tensor):
            return packed
        i, dtype, offset, size, stride = packed
        st = self.storages[i]
        return torch.empty(0, dtype=dtype, device=st.device).set_(
            st, offset, size, stride)

    def read(self, packed) -> torch.Tensor:
        """A packed tensor on the card it was packed on: when OFFLOAD has
        moved the box to the host, a copy back, made once that move is done
        (the compute stream waits for the box's event first). The executor
        reads a slice's retained KV this way."""
        t = self.unpack(packed)
        if self.moved and t.device.type == "cpu":
            torch.cuda.current_stream(self.home).wait_event(self.event)
            t = t.to(self.home, non_blocking=True)
        return t

    def hooks(self):
        """The saved-tensor hooks a forward runs under to fill this box."""
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)

    def nbytes(self) -> int:
        return sum(st.nbytes() for st in self.storages)


def _as_bytes(st) -> torch.Tensor:
    return torch.empty(0, dtype=torch.uint8, device=st.device).set_(st)


def to_host(stash: Any) -> Any:
    """Move the CUDA storages of a stash's box to pinned host memory (D2H
    on the side stream)."""
    box = stash.box
    moved = [i for i, st in enumerate(box.storages) if st.device.type == "cuda"]
    if not moved:
        return stash
    box.home = box.storages[moved[0]].device
    side = box.stream = torch.cuda.Stream(box.home)
    side.wait_stream(torch.cuda.current_stream(box.home))
    with torch.cuda.stream(side):
        for i in moved:
            src = _as_bytes(box.storages[i])
            dst = torch.empty(src.numel(), dtype=torch.uint8, pin_memory=True)
            dst.copy_(src, non_blocking=True)
            src.record_stream(side)
            box.storages[i] = dst.untyped_storage()
        box.event = side.record_event()
    box.moved = moved
    return stash


def to_device(stash: Any) -> Any:
    """Move what ``to_host`` moved back to its card (H2D on the side
    stream; the compute stream waits for the copy)."""
    box = stash.box
    if not box.moved:
        return stash
    compute = torch.cuda.current_stream(box.home)
    # allocated on the compute stream, which frees them after the backward;
    # the side stream waits for every earlier use of those blocks first
    dst = [torch.empty(box.storages[i].nbytes(), dtype=torch.uint8,
                       device=box.home) for i in box.moved]
    side = box.stream
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        for i, d in zip(box.moved, dst):
            d.copy_(_as_bytes(box.storages[i]), non_blocking=True)
            box.storages[i] = d.untyped_storage()
        box.event = side.record_event()
    compute.wait_event(box.event)
    box.moved = []
    return stash


HOST_OFFLOAD = respol.register(respol.ResidencyPolicy(
    "host_offload", OFFLOAD, FETCH, mechanism="host",
    default_cap=respol.residency_cap,
    cap_roof=respol.residency_cap_roof))
