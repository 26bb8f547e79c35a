"""Collectives of CUDA tensors between ranks of one host, staged through
pinned host memory into gloo.

Port-only. Ranks that share one card cannot use NCCL (it refuses two ranks
on one device), and the collectives DTensor runs on a mesh of device type
``"cuda"`` (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``) reach the process group's backend
for the tensors' device through PyTorch's ``c10d`` collective ops.
``install()`` registers, for the ``CUDA`` dispatch key of those ops, kernels that
copy the CUDA inputs into pinned host buffers, run the collective of the
group's gloo backend on them, and copy the results back into the CUDA
outputs, explicitly and synchronously. The group is an ordinary gloo
group (``launch.ranks.run_ranks`` makes one in each rank); CPU tensors
take gloo's own kernels as before. Nothing here is NVLink: the times of a
run on it say nothing of a card-to-card transport.

Every staged collective over two or more ranks adds one to its kind's
count of ``pipeline/collectives.py``'s counter (``collectives.counted``),
with its output's bytes and the host seconds it took: this is the one
staging of collectives in the port, ``collectives.all_reduce_`` included;
``collectives.ppermute`` stages its own send and receive.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch._C import _distributed_c10d as c10d

from repro_torch.pipeline import collectives

TRANSPORT = ("gloo, CUDA tensors staged through pinned host memory "
             "(launch/staged.py)")

_LIB = []  # the registration lives as long as its Library object


def _work():
    """A finished Work, as the c10d ops return one."""
    fut = torch.futures.Future()
    fut.set_result(None)
    return c10d._create_work_from_future(fut).boxed()


def _pin(t, copy=True):
    """A host copy of ``t`` (pinned if ``t`` is on the card), or with
    ``copy=False`` an empty buffer of its shape."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return h.copy_(t) if copy else h


def _gloo(pg):
    return dist.ProcessGroup.unbox(pg)._get_backend(torch.device("cpu"))


def _op(rop):
    """The ``ReduceOp`` of the op's boxed argument."""
    return dist.ReduceOp(dist.ReduceOp.RedOpType(rop.op()))


def _run(kind, pg, out, fn):
    if dist.ProcessGroup.unbox(pg).size() == 1:
        fn().wait()
        return
    with collectives.counted(kind, out):
        fn().wait()


def _allreduce(tensors, pg, rop, sparse_indices, async_op=True, timeout=-1):
    hs = [_pin(t) for t in tensors]
    opts = c10d.AllreduceOptions()
    opts.reduceOp = _op(rop)
    _run("all-reduce", pg, tensors[0], lambda: _gloo(pg).allreduce(hs, opts))
    for t, h in zip(tensors, hs):
        t.copy_(h)
    return tensors, _work()


def _allgather_base(output, input, pg, async_op=True, timeout=-1):
    ho, hi = _pin(output, copy=False), _pin(input)
    _run("all-gather", pg, output,
         lambda: _gloo(pg)._allgather_base(ho, hi, c10d.AllgatherOptions()))
    output.copy_(ho)
    return output, _work()


def _allgather_coalesced(outputs, inputs, pg, async_op=True):
    for o, i in zip(outputs, inputs):
        _allgather_base(o, i, pg)
    return _work()


def _reduce_scatter_base(output, input, pg, rop, async_op=True, timeout=-1):
    ho, hi = _pin(output, copy=False), _pin(input)
    opts = c10d.ReduceScatterOptions()
    opts.reduceOp = _op(rop)
    _run("reduce-scatter", pg, output,
         lambda: _gloo(pg)._reduce_scatter_base(ho, hi, opts))
    output.copy_(ho)
    return output, _work()


def _reduce_scatter_coalesced(outputs, inputs, pg, rop, async_op=True,
                              timeout=-1):
    for o, i in zip(outputs, inputs):
        _reduce_scatter_base(o, i, pg, rop)
    return _work()


def _alltoall_base(output, input, pg, output_split_sizes, input_split_sizes,
                   async_op=True, timeout=-1):
    ho, hi = _pin(output, copy=False), _pin(input)
    _run("all-to-all", pg, output, lambda: _gloo(pg).alltoall_base(
        ho, hi, output_split_sizes, input_split_sizes, c10d.AllToAllOptions()))
    output.copy_(ho)
    return _work()


def install(dispatch_key: str = "CUDA"):
    """Register the staged kernels for ``dispatch_key`` of the ``c10d``
    ops (once a process). The tests register them for ``CPU``, where the
    staging copies are host to host."""
    if _LIB:
        return
    lib = torch.library.Library("c10d", "IMPL")
    for name, fn in (("allreduce_", _allreduce),
                     ("_allgather_base_", _allgather_base),
                     ("allgather_into_tensor_coalesced_", _allgather_coalesced),
                     ("_reduce_scatter_base_", _reduce_scatter_base),
                     ("reduce_scatter_tensor_coalesced_", _reduce_scatter_coalesced),
                     ("alltoall_base_", _alltoall_base)):
        lib.impl(name, fn, dispatch_key)
    _LIB.append(lib)
