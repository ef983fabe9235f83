"""Process-group bring-up and the mesh heartbeat.
Port of pocket_tts_tpu/parallel/multihost.py.

The JAX package runs one process per host and lets `jax.devices()` span the
job. The port runs one process per device: `initialize_multihost` joins this
process to a `torch.distributed` group (NCCL for a card, gloo for the CPU)
from explicit arguments or from the environment (`MASTER_ADDR`,
`MASTER_PORT`, `RANK`, `WORLD_SIZE`), and pins the process to its card.
With neither, it makes a group of one on a free localhost port: collectives
need a group even where the JAX package's call is a no-op.
"""

from __future__ import annotations

import datetime
import logging
import os
import socket

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

INIT_TIMEOUT_S = 600.0  # how long a process waits for its peers to join


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device | None = None,
) -> dict:
    """Join (or make) this process's group. `coordinator_address`: host:port
    of process 0; `device`: the card by default (cuda:{rank % device count},
    NCCL), "cpu" for gloo. A group that already exists is kept. Returns the
    JAX package's summary dict, one device per process."""
    if not dist.is_initialized():
        env = os.environ
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
        if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world = num_processes or 1
        if world > 1 and (coordinator_address is None or process_id is None):
            raise ValueError(f"a job of {world} processes needs the coordinator's "
                             "address and this process's id")
        rank = process_id or 0
        coordinator_address = coordinator_address or f"127.0.0.1:{_free_port()}"
        cpu = device is not None and torch.device(device).type == "cpu"
        if not cpu:
            if not torch.cuda.is_available():
                raise RuntimeError("No CUDA device found; pass device='cpu' for gloo on the CPU")
            index = torch.device(device).index if device is not None else None
            torch.cuda.set_device(rank % torch.cuda.device_count() if index is None else index)
        dist.init_process_group("gloo" if cpu else "nccl",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }
    logger.info("multihost: %s", info)
    return info


def group_device() -> torch.device:
    """The device the default group's collectives take tensors on."""
    if dist.get_backend() == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def assert_mesh_healthy(mesh) -> bool:
    """Liveness collective over the mesh: every rank contributes 1, summed
    over each of the mesh's dims in turn; the total must equal the mesh's
    size. A rank that is gone makes the collective fail or time out."""
    ones = torch.ones((1,), dtype=torch.int32, device=group_device())
    for name in mesh.mesh_dim_names:
        dist.all_reduce(ones, group=mesh.get_group(name))
    return int(ones.item()) == mesh.size()
