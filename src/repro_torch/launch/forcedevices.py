"""Run one function in N local ranks (the torch counterpart of
``repro.launch.forcedevices``, which makes one host present N devices).

:func:`run_ranks` spawns ``world_size`` processes (``torch.multiprocessing``,
spawn start method), joins them into one gloo world over
``tcp://localhost:<free port>``, and calls ``fn(rank, world_size, *args)``
in each.  The ranks compute on the CPU or all on ``cuda:0`` (the caller's
function picks the device; gloo, because NCCL refuses two ranks on one
GPU).  It returns the ranks' results in rank order.

A failure in any rank fails the caller: its traceback is raised as a
``RuntimeError`` and the other ranks are terminated.  Every rank has a
timeout — the process group's, so a rank whose peers diverged fails at
its next collective instead of hanging — and the caller waits at most
``timeout_s`` in all before it terminates what is left and raises.

``fn`` and ``args`` must be picklable: ``fn`` a module-level function of
a module the children can import.
"""

from __future__ import annotations

import queue
import socket
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def _rank_main(fn, rank: int, world_size: int, port: int, args: tuple,
               timeout_s: float, threads: int, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=world_size, rank=rank,
            timeout=timedelta(seconds=timeout_s))
        try:
            out = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                               # noqa: BLE001
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable[..., Any], world_size: int,
              args: Sequence[Any] = (), *, timeout_s: float = 120.0,
              threads: int = 1) -> List[Any]:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned ranks
    of one gloo world; return their results in rank order.  ``threads``
    sets each rank's intra-op threads (0 leaves torch's default)."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, port, tuple(args),
                               timeout_s, threads, results),
                         daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: dict = {}
    try:
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    f"run_ranks: {world_size - len(got)} of {world_size} "
                    f"ranks gave no result within {timeout_s} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive()
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"run_ranks: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        results.close()
    return [got[r] for r in range(world_size)]
