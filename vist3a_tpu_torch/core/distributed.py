"""Multi-process runtime: one process drives one GPU.

Port of `vist3a_tpu/core/distributed.py` (the reference's
`utils/dist_util.py`: `setup_dist` :25-43, `cleanup` :46,
`is_main_process` :52, `barrier` :64).  The JAX package has one controller
over all devices; torch runs one process per device, launched by
`torchrun --nproc_per_node N`, which sets `RANK`, `WORLD_SIZE`,
`LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`.

`setup_dist` initialises the default process group from that environment:
NCCL on the card, with `torch.cuda.set_device(LOCAL_RANK)` (rank pinned to
device, as `dist_util.py` pins it), or gloo when the caller asks for the
CPU.  Without the environment it does nothing: a single process, as the
JAX package's `setup_dist` does without a coordinator.  With it, a failed
NCCL init raises; there is no fallback to gloo or to one process.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

RANK_ENV = ("RANK", "WORLD_SIZE")
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT")


def launched(init_method: str | None = None) -> bool:
    """Whether the launcher's environment is present (the rendezvous
    address only where no `init_method` names another)."""
    need = RANK_ENV if init_method else RANK_ENV + RENDEZVOUS_ENV
    return all(k in os.environ for k in need)


def setup_dist(device: torch.device | str = "cuda", *,
               init_method: str | None = None,
               timeout: datetime.timedelta | None = None) -> bool:
    """Initialise the default process group from the launcher's
    environment; NCCL on "cuda", gloo on "cpu".  `init_method` replaces
    the `MASTER_ADDR` / `MASTER_PORT` rendezvous (the CPU tests give a
    `file://` one).  Returns True when this call initialised the group (the
    caller then owns its `cleanup`), False when a group was already up or
    no launcher environment is present."""
    if dist.is_initialized() or not launched(init_method):
        return False
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    kw = {"rank": rank, "world_size": world, "init_method": init_method}
    if timeout is not None:
        kw["timeout"] = timeout
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("setup_dist: a launcher environment asks for "
                               "NCCL, and CUDA is not available")
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        # device_id makes NCCL build its communicator now, so a failure
        # raises here and not at the first collective
        dist.init_process_group("nccl", device_id=torch.device("cuda", local),
                                **kw)
    else:
        dist.init_process_group("gloo", **kw)
    return True


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """`dist_util.py:52`."""
    return get_rank() == 0


def barrier() -> None:
    """`dist_util.py:64`: every rank arrives before any leaves; nothing in
    a single process."""
    if dist.is_initialized():
        dist.barrier()


def cleanup() -> None:
    """`dist_util.py:46`: destroy the default group, so that a later phase
    of the same process starts clean."""
    if dist.is_initialized():
        dist.destroy_process_group()
