"""Multi-process initialization: `torch.distributed` for one process a GPU.

Every process runs the same program (SPMD) on its own x-slab.  Under
torchrun the rank, the world size, the local rank and the rendezvous address
come from its environment:

    torchrun --nproc_per_node=4 my_run.py

    from py21cmfast_torch.parallel import mesh, multihost
    from py21cmfast_torch.parallel.driver import run_sharded_coeval
    multihost.initialize()          # RANK, WORLD_SIZE, LOCAL_RANK, MASTER_*
    m = mesh.make_mesh()            # NCCL on cuda:LOCAL_RANK
    out = run_sharded_coeval(inputs, [8.0], mesh=m)   # this rank's slabs

Host-side work (the tables) is deterministic and repeated on every rank, so
nothing is broadcast.  Without torchrun's environment and without arguments
the world is this one process.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_initialized", "process_info", "shutdown", "local_device_index"]

_initialized = False
_local_device = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None,
               *,
               backend: str = "nccl") -> None:
    """Join (or form) the default process group.

    `coordinator_address` is "host:port" of rank 0 (torchrun's MASTER_ADDR
    and MASTER_PORT when None; a free localhost port for a world of one),
    `num_processes` the world size (WORLD_SIZE, else 1), `process_id` this
    rank (RANK, else 0) and `local_device_ids` the card this process drives
    (its first entry; LOCAL_RANK, else 0).  NCCL is the default backend and
    needs a card; gloo only when asked.  Idempotent: a second call, or a
    call after the caller formed the group itself, does nothing."""
    global _initialized, _local_device
    if _initialized or dist.is_initialized():
        _initialized = True
        return
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    if local_device_ids is not None:
        _local_device = int(list(local_device_ids)[0])
    else:
        _local_device = int(env.get("LOCAL_RANK", 0))
    if coordinator_address is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif world == 1:
            coordinator_address = f"localhost:{_free_port()}"
        else:
            raise RuntimeError(
                "multihost.initialize: a world of several processes needs the coordinator's "
                "address (launch with torchrun, or pass coordinator_address='host:port')")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: the NCCL backend needs a CUDA device; "
                               "pass backend='gloo' to run on the CPU")
        torch.cuda.set_device(_local_device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            rank=rank, world_size=world)
    _initialized = True


def is_initialized() -> bool:
    return _initialized or dist.is_initialized()


def process_info() -> tuple[int, int]:
    """(rank, world size): (0, 1) before `initialize`."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_device_index() -> int:
    """The card this process drives: `local_device_ids[0]` or LOCAL_RANK."""
    if _local_device is not None:
        return _local_device
    return int(os.environ.get("LOCAL_RANK", 0))


def shutdown() -> None:
    """Leave the default process group (after which `initialize` may form a
    new one)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
