"""Joining a process group: one process per GPU, on one node or several.

Port of ``monocon_tpu/parallel/distributed.py``. The JAX package joins a
multi-host cluster with ``jax.distributed.initialize`` from
``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``;
the port joins a ``torch.distributed`` group from torchrun's environment:
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``. :func:`spawn_ranks` sets that environment itself for
one process per local device (``torch.multiprocessing``, start method
``spawn``), as the JAX package's one process drives every local device.

The backend is NCCL between GPUs and gloo between CPU processes. The JAX
package gives each process its rows of a global batch through
``shard_global_batch``; here each rank's loader reads only its rows
(``data/loader.py``, :func:`parallel.mesh.rank_rows`).

:func:`launch` is the CLIs' entry: under torchrun every process joins its
group; otherwise ``TPU.NUM_DEVICES`` (-1: every visible GPU; on the CPU,
the count asked for, -1 meaning one) clamped to divide ``DATA.BATCH_SIZE``
gives the processes to spawn, one meaning this process alone, as before.
``TPU.MULTIHOST`` asks for several nodes, which only torchrun's
environment can describe. With ``TPU.SPATIAL_SHARDS = S > 1`` the count is
``D x S``: ``D`` data shards, the largest count at most the devices over
``S`` that divides the batch, as the JAX engine sizes its mesh; fewer
devices than ``S`` raise.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import data_shards

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def launched_by_torchrun() -> bool:
    """Whether this process has torchrun's environment."""
    return all(k in os.environ for k in TORCHRUN_ENV)


def initialize_distributed(device_type: str = "cuda",
                           backend: Optional[str] = None) -> torch.device:
    """Join the process group of torchrun's environment and return this
    rank's device: ``cuda:LOCAL_RANK`` (made the current device) or the
    CPU. ``backend`` defaults to ``nccl`` for CUDA and ``gloo`` for the
    CPU; ``gloo`` on CUDA runs several ranks on one card, which NCCL
    refuses."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"no process group to join: {', '.join(missing)} unset (launch "
            "with torchrun, or set TPU.NUM_DEVICES for one process per "
            "local device)")
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))
    return device


def rank_and_world() -> "tuple[int, int]":
    """(rank, world size) of the default group; (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawned(rank: int, world: int, port: int, fn: Callable,
             args: Sequence[Any]) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    fn(*args)


def spawn_ranks(world: int, fn: Callable, *args: Any) -> None:
    """Run ``fn(*args)`` in ``world`` new processes on this node, each
    with torchrun's environment for its rank (``LOCAL_RANK`` = rank), and
    wait for them; raises if one fails. ``fn`` must be importable by name
    (the processes are spawned, not forked)."""
    mp.start_processes(_spawned, args=(world, free_port(), fn, args),
                       nprocs=world, start_method="spawn")


def num_processes(cfg, device: torch.device) -> int:
    """The processes that ``cfg`` asks for on this node: ``TPU.NUM_DEVICES``
    (-1 or 0: every visible GPU, or on the CPU one; at most the visible
    GPUs) over ``TPU.SPATIAL_SHARDS`` bands, the data shards clamped to the
    largest count that divides ``DATA.BATCH_SIZE``, times the bands."""
    asked = int(cfg.TPU.NUM_DEVICES)
    spatial = max(1, int(cfg.TPU.SPATIAL_SHARDS))
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        asked = visible if asked <= 0 else min(asked, visible)
    asked = max(asked, 1)
    if asked < spatial:
        raise ValueError(
            f"TPU.SPATIAL_SHARDS={spatial} needs {spatial} processes, one "
            f"a device; {asked} {device.type} device(s) are "
            + ("visible" if device.type == "cuda" else
               "asked for (set TPU.NUM_DEVICES)"))
    return data_shards(asked // spatial, int(cfg.DATA.BATCH_SIZE)) * spatial


def _rank_entry(device_type: str, entry: Callable, cfg,
                args: Sequence[Any]) -> None:
    device = initialize_distributed(device_type)
    try:
        if device.type == "cpu":
            # The node's cores shared among its ranks.
            local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
            torch.set_num_threads(max(1, torch.get_num_threads() // local))
        entry(cfg, device, *args)
    finally:
        dist.destroy_process_group()


def launch(entry: Callable, cfg, device: torch.device, *args: Any) -> None:
    """Run ``entry(cfg, device, *args)`` on every rank of the run that
    ``cfg`` describes (see the module docstring), each with its own
    device; ``device`` names this process's device and, for the ranks,
    the device type. ``entry`` must be importable by name."""
    if launched_by_torchrun():
        _rank_entry(device.type, entry, cfg, args)
        return
    if cfg.TPU.MULTIHOST:
        raise RuntimeError(
            "TPU.MULTIHOST: several nodes join through torchrun's "
            "environment; launch with torchrun --nnodes N --nproc_per_node "
            "GPUS --rdzv_endpoint HOST:PORT -m ...")
    world = num_processes(cfg, device)
    if world == 1:
        entry(cfg, device, *args)
    else:
        spawn_ranks(world, _rank_entry, device.type, entry, cfg, args)
