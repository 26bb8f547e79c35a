"""Rank launcher: N ``torch.distributed`` ranks as N processes of one host.

Port-only. ``run_ranks(fn, world, ...)`` spawns ``world`` processes with
the ``spawn`` start method (a process that has touched CUDA cannot be
forked), gives each a gloo process group on a free ``tcp://localhost``
port with a timeout, calls ``fn(rank, world, *args)`` there and returns the
ranks' return values in rank order (each must pickle).

Nothing hangs and nothing fails quietly: the parent waits until a
deadline, and on a timeout or on the first rank that raises or dies it
kills every rank and raises (``RankError``, or ``TimeoutError`` naming the
ranks still running). Each rank runs one intra-op thread: the ranks share
the host's cores (on the card, a rank's host work is launches and copies).

    from repro_torch.launch.ranks import run_ranks
    results = run_ranks(my_rank_fn, 4, args=(cfg,), timeout_s=60)

The backend is gloo and nothing else, with the collectives of CUDA
tensors staged through pinned host memory where asked
(``launch/staged.py``): the ranks of one host may share one card, where
NCCL is never set up. One rank a card over NCCL waits for a host with two
or more cards (ROADMAP A9).

``fn`` must be a module-level function of a module the child can import
(a spawned child imports the parent's ``sys.path``). Build a CUDA kernel
in the parent before spawning, so that the ranks only load it.
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank raised or died; the message holds its traceback or exit code."""


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, timeout_s, fn, args, out, staged_key):
    torch.set_num_threads(1)
    try:
        if staged_key:
            from repro_torch.launch import staged
            staged.install(staged_key)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        result = fn(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - every failure goes to the parent
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *, args=(), timeout_s: float = 60.0,
              staged_key: str = ""):
    """``[fn(rank, world, *args) for rank in range(world)]``, each in a
    spawned process of a ``world``-rank gloo group. ``staged_key="CUDA"``
    installs ``launch/staged.py``'s kernels in each rank first (CUDA
    tensors' collectives staged through host memory into gloo, for
    DTensors on the card; the tests take ``"CPU"``). Raises
    ``TimeoutError`` past ``timeout_s`` seconds and ``RankError`` on the
    first rank that fails; every rank is killed before either."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, timeout_s, fn, args, out,
                               staged_key))
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    results = {}
    try:
        for p in procs:
            p.start()
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                waiting = sorted(set(range(world)) - set(results))
                raise TimeoutError(
                    f"ranks {waiting} of {world} still running after "
                    f"{timeout_s:.0f} s; all killed")
            try:
                rank, ok, payload = out.get(timeout=min(0.5, left))
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:  # died without a word (a signal, a native crash)
                    time.sleep(0.5)  # its traceback may still be in the pipe
                    if out.empty():
                        raise RankError(f"rank {dead[0][0]} exited with code "
                                        f"{dead[0][1]}")
                continue
            if not ok:
                raise RankError(f"rank {rank} of {world} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)
        out.close()
    return [results[r] for r in range(world)]

