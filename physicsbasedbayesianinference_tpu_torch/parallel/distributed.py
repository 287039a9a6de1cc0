"""Multi-process runtime initialisation (port of the JAX package's
``parallel/distributed.py``).

A walker shard is one process per device. Processes join one
``torch.distributed`` group: NCCL when the rank's device is a CUDA device
(``cuda:LOCAL_RANK``), gloo when it is the CPU. Launched with
``python -m torch.distributed.run --nproc_per_node=K ...`` (torchrun), every
argument comes from the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``); pass them explicitly
only for a cluster launched otherwise. A CUDA rank whose NCCL group fails
to form raises: it never falls back to gloo or to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import default_device


def rank_device(group=None) -> torch.device:
    """The device of this process's shard: the current CUDA device under
    an NCCL group, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _summary() -> dict:
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        # one device a process
        "local_devices": 1,
        "global_devices": count,
    }


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[str] = None,
) -> dict:
    """Join this process to the run's process group (idempotent; a no-op
    for one process with no launcher environment). Returns a summary dict
    with the JAX package's keys.

    ``coordinator_address``: ``host:port`` of rank 0 (or a full
    ``init_method`` URL such as ``file:///path``); without it the
    environment's ``MASTER_ADDR``/``MASTER_PORT``. ``num_processes``,
    ``process_id``: the world size and this rank, else ``WORLD_SIZE`` and
    ``RANK``. ``device``: ``"cuda"`` or ``"cpu"``; by default the type of
    ``device.default_device()`` (the card; without one it raises unless
    the CPU was asked for). The rank's device is ``cuda:LOCAL_RANK`` (``LOCAL_RANK``,
    else the rank), made the current device.
    """
    if dist.is_initialized():
        return _summary()
    env = os.environ
    world = (num_processes if num_processes is not None
             else int(env.get("WORLD_SIZE", "1")))
    if coordinator_address is None and world <= 1:
        return _summary()
    rank = process_id if process_id is not None else int(env.get("RANK", "0"))
    kind = device or default_device().type
    if kind == "cuda":
        local = int(env.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} wants cuda:{local}, but this host has "
                f"{torch.cuda.device_count()} CUDA devices")
        torch.cuda.set_device(local)
    elif kind != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method=init_method, rank=rank,
                            world_size=world)
    return _summary()
