"""Multi-process bootstrap (port of ``repro.launch.multihost``).

``init_distributed`` starts the ``torch.distributed`` world that the
sharded miner's mesh (``launch.mesh.make_mining_mesh``) spans.  Its
settings come from the arguments or from torchrun's environment
(``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); when neither
names a world it does nothing, and a single process mines alone.

``Heartbeat`` is the liveness barrier of long runs: an all-reduce of one
scalar every ``interval_steps`` steps; a peer that is gone or wedged makes
it fail after the process group's timeout.

    python -m repro_torch.launch.multihost --init-method tcp://localhost:29500 \
        --world-size 2 --rank 0 --backend gloo     # (and rank 1 beside it)
"""

from __future__ import annotations

import argparse
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def default_backend() -> str:
    """NCCL where there is a CUDA device, else gloo."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout_s: float = 300.0) -> bool:
    """Initialise the default process group from the arguments or from
    torchrun's environment.  Returns whether a world is up (``False``:
    neither names one, nothing was done).  A world already up is kept."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            return False               # single process: nothing to do
        init_method = "env://"
    world_size = int(world_size if world_size is not None
                     else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    dist.init_process_group(backend or default_backend(),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s))
    return True


def _barrier_device() -> torch.device:
    return torch.device("cuda" if dist.get_backend() == "nccl" else "cpu")


class Heartbeat:
    """Cross-process liveness barrier: an all-reduce of one scalar each
    ``interval_steps`` steps.  A failure (a peer gone, or the group's
    timeout) calls ``on_failure`` and re-raises, so the caller can save
    and exit non-zero."""

    def __init__(self, interval_steps: int = 100):
        self.interval = interval_steps
        self.beats = 0

    def maybe_beat(self, step: int, on_failure=None) -> None:
        if step % self.interval:
            return
        try:
            one = torch.ones((), device=_barrier_device())
            dist.all_reduce(one)
            if int(one.item()) != dist.get_world_size():
                raise RuntimeError(f"heartbeat summed {one.item()} over "
                                   f"{dist.get_world_size()} processes")
            self.beats += 1
        except Exception:
            if on_failure is not None:
                on_failure()
            raise


def main() -> None:
    ap = argparse.ArgumentParser(
        description="multi-process smoke: init + one all-reduce barrier")
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()
    if not init_distributed(args.init_method, args.world_size, args.rank,
                            backend=args.backend):
        print("no world named (flags or MASTER_ADDR/WORLD_SIZE): one "
              "process")
        return
    Heartbeat(1).maybe_beat(0)
    print(f"rank {dist.get_rank()}/{dist.get_world_size()} "
          f"({dist.get_backend()}): barrier ok")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
