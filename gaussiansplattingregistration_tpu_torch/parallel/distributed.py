"""Process-group setup: counterpart of
`gaussiansplattingregistration_tpu/parallel/distributed.py`.

Launch one process per GPU (`torchrun --nproc-per-node N -m
gaussiansplattingregistration_tpu_torch.cli ...`) and call `initialize()`
once per process before anything is allocated on the card. It reads
torchrun's `RANK`, `WORLD_SIZE`, `LOCAL_RANK` and `MASTER_ADDR`/`MASTER_PORT`
and makes `cuda:LOCAL_RANK` the current device, so every
`torch.device("cuda")` of the port means the rank's own card. Without that
environment it builds a world of one on an in-process store, so a
single-process caller runs the same collective code (the JAX package's
mesh of the local devices). A lost rank fails its collective; the job
restarts from its latest checkpoint (`utils/checkpoint.py`).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from gaussiansplattingregistration_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("gsr_torch.distributed")


def initialize(backend: Optional[str] = None, device=None,
               init_method: Optional[str] = None) -> bool:
    """Join the default process group; a no-op when one is up already.

    `device` (default `cuda`) picks the backend when `backend` is None:
    `nccl` for CUDA, `gloo` for the CPU. Under torchrun's environment the
    rank and world size come from `RANK` and `WORLD_SIZE`, the rendezvous
    from `init_method` (default `env://`, i.e. `MASTER_ADDR`/`MASTER_PORT`;
    a `file://` path needs no port), and `cuda:LOCAL_RANK` becomes the
    current device first. Otherwise the world is this process alone, on a
    `HashStore`. Returns True when this call made the group: its caller
    owns it and ends it with `shutdown()`."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    logger.info("distributed: rank %d/%d, backend %s, device %s", dist.get_rank(),
                dist.get_world_size(), dist.get_backend(),
                f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu")
    return True


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The group's size, or torchrun's `WORLD_SIZE` (1 without it) before
    `initialize()`."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_primary() -> bool:
    """True on the process that should print and write logs/checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def global_mesh(data: int = 1, device_type: Optional[str] = None):
    """Mesh over every rank of the default group (`initialize()` first)."""
    from gaussiansplattingregistration_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=data, device_type=device_type)
