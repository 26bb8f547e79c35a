"""Differentiable collectives over ``torch.distributed`` process groups.

Port-only: the JAX package takes these from ``jax.lax`` inside
``shard_map``. Each op runs on every rank of its group, as an SPMD program:

  * ``ppermute(x, perm, group)``: ``perm`` is a list of (source, dest)
    pairs of group-local ranks; each rank sends ``x`` to its dest and
    returns what its source sent (zeros where no pair names it as a dest,
    as ``lax.ppermute``). Its backward sends the cotangent along the
    inverted permutation. A rank that maps to itself copies locally and
    never sends to itself; it still counts the op, as every rank of the
    group takes part in it.
  * ``psum(x, group)``: the sum over the group. Its backward is the
    identity on each rank: every rank's term enters the sum with weight 1,
    and every rank differentiates the same total.
  * ``pmean(x, group)``: the mean; its backward divides by the group size.

Every hop is one ``dist.batch_isend_irecv`` that holds both the send and
the receive, so a ring of hops cannot deadlock on the order of blocking
sends. A collective over a group of one rank moves nothing: it is neither
issued nor counted.

**Transport.** The group's backend chooses it, never a failure. Gloo's
send and receive hand the tensor's raw pointer to its TCP transport, so on
a gloo group a CUDA tensor is staged through pinned host memory,
explicitly, in both directions; ``all_reduce_`` is ``dist.all_reduce``,
whose CUDA tensors on gloo take the staged kernels of
``launch/staged.py``. Under NCCL (one rank a card) a CUDA tensor is sent
as it is. NCCL with two ranks on one card is never set up here.
``transport(group)`` names the path a CUDA tensor takes.

**Counter.** Every op adds one to its kind's count, its output's bytes to
its kind's bytes and the host time it took to its kind's seconds on the
calling rank (``reset()`` / ``read()``), the
counterpart of ``launch/roofline.collective_bytes``'s parse of the HLO:
the JAX package counts the ops of a compiled program, whose ``lax.scan``
body holds one op per tick, where this counter counts the ops a step
really runs.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

_OPS: Dict[str, int] = {k: 0 for k in KINDS}
_BYTES: Dict[str, float] = {k: 0.0 for k in KINDS}
_SECONDS: Dict[str, float] = {k: 0.0 for k in KINDS}


def reset():
    """Set every kind's ops, bytes and seconds to 0 (at the start of a step)."""
    for k in KINDS:
        _OPS[k], _BYTES[k], _SECONDS[k] = 0, 0.0, 0.0


def read() -> Dict[str, Dict[str, float]]:
    """{"ops": {kind: n}, "bytes": {kind: bytes}, "seconds": {kind: s}}
    since the last reset, on this rank. The seconds are the host clock
    inside the ops: a staged op waits for its copies and its peer, so on
    gloo they are the time the rank spent in collectives."""
    return {"ops": dict(_OPS), "bytes": dict(_BYTES), "seconds": dict(_SECONDS)}


_DEPTH = [0]


@contextlib.contextmanager
def counted(kind: str, t: torch.Tensor):
    """Count one op of ``kind`` with ``t``'s bytes and the host seconds the
    block takes, unless an enclosing block counts it already: the staged
    kernels of ``launch/staged.py`` count what DTensor issues, and inside
    ``all_reduce_`` the op it already counted."""
    _DEPTH[0] += 1
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _DEPTH[0] -= 1
        if not _DEPTH[0]:
            _OPS[kind] += 1
            _BYTES[kind] += t.numel() * t.element_size()
            _SECONDS[kind] += time.perf_counter() - t0


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def transport(group) -> str:
    """How a CUDA tensor crosses ``group``: staged through pinned host
    memory (gloo) or sent from the card (any other backend)."""
    if dist.get_backend(group) == dist.Backend.GLOO:
        return "gloo, staged through pinned host memory"
    return f"{dist.get_backend(group)}, from device memory"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of CUDA tensor ``t`` (the copy waits for it)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


# ---------------------------------------------------------------------------
# The raw ops (no autograd)
# ---------------------------------------------------------------------------
def ppermute_raw(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group
                 ) -> torch.Tensor:
    """One hop of ``x`` along ``perm`` (group-local (source, dest) pairs)."""
    x = x.contiguous()
    me, n = dist.get_rank(group), dist.get_world_size(group)
    dests = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    assert len(dests) <= 1 and len(srcs) <= 1, (perm, me)
    if n == 1:
        return x.clone()
    with counted("collective-permute", x):
        if dests == [me] and srcs == [me]:  # the odd middle stage: its own partner
            return x.clone()
        return _hop(x, me, dests, srcs, group)


def _hop(x, me, dests, srcs, group):
    staged = _staged(group, x)
    out = torch.zeros_like(x)
    recv = (torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if staged
            else out)
    ops = []
    if dests:
        assert dests[0] != me, (perm, me)
        ops.append(dist.P2POp(dist.isend, _host(x) if staged else x,
                              dist.get_global_rank(group, dests[0]), group))
    if srcs:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, srcs[0]), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if srcs and staged:
        out.copy_(recv)
    return out


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; returns ``t``. A CUDA tensor on
    a gloo group takes the staged kernels of ``launch/staged.py``, which
    the ranks install (``launch.ranks.run_ranks(staged_key="CUDA")``)."""
    if dist.get_world_size(group) == 1:
        return t
    with counted("all-reduce", t):
        dist.all_reduce(t, group=group)
    return t


# ---------------------------------------------------------------------------
# Differentiable ops
# ---------------------------------------------------------------------------
def inverse(perm: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return [(d, s) for s, d in perm]


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return ppermute_raw(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, inverse(ctx.perm), ctx.group), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = dist.get_world_size(group)
        return all_reduce_(x.clone(), group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def ppermute(x, perm, group):
    return _PPermute.apply(x, list(perm), group)


def psum(x, group):
    return _PSum.apply(x, group)


def pmean(x, group):
    return _PMean.apply(x, group)
