"""Data parallelism over the ranks of a process group.

The data-parallel part of ``monocon_tpu/parallel/mesh.py``. There a mesh's
``data`` axis splits each global batch over the devices, and XLA inserts
the gradient and BatchNorm all-reduces. Here each rank is one process and
one device: it loads its own rows of every global batch
(:func:`rank_rows`), starts from rank 0's state (:func:`replicate_state`),
and ``DistributedDataParallel`` with the synced BN moments of
``models/layers.py`` and the global loss sums of
``engine/train_step.py`` stands in for the all-reduces.

The JAX package's second axis, ``TPU.SPATIAL_SHARDS > 1`` (image height
split over devices, halo exchange by GSPMD), has no counterpart here;
``config/defaults.py::check_port_support`` refuses it.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel


def data_shards(available: int, batch_size: int) -> int:
    """The largest count of data shards, at most ``available``, that
    divides ``batch_size``, as the JAX engine clamps its mesh's data axis
    (``engine/engine.py:94-116``): ``DATA.BATCH_SIZE`` is the global
    batch."""
    shards = max(1, available)
    while shards > 1 and batch_size % shards != 0:
        shards -= 1
    return shards


def rank_rows(batch_size: int, num_real: int, rank: int,
              world: int) -> List[Tuple[int, bool]]:
    """(source row, valid) of each of this rank's rows of a global batch of
    ``batch_size`` rows of which the first ``num_real`` are real: rows
    ``rank * R`` to ``(rank + 1) * R - 1``, ``R = batch_size // world``.
    A row past ``num_real`` repeats row ``(row - num_real) % num_real``,
    as the JAX loader's ``pad_to_batch`` fills a remainder batch."""
    if batch_size % world:
        raise ValueError(f"a global batch of {batch_size} does not split "
                         f"over {world} ranks")
    per_rank = batch_size // world
    rows = range(rank * per_rank, (rank + 1) * per_rank)
    return [(j if j < num_real else (j - num_real) % num_real, j < num_real)
            for j in rows]


@torch.no_grad()
def replicate_state(module: torch.nn.Module,
                    group: Optional[dist.ProcessGroup] = None) -> None:
    """Give every rank rank 0's parameters and buffers."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        dist.broadcast(t, src=0, group=group)


def data_parallel(module: torch.nn.Module,
                  device: torch.device) -> DistributedDataParallel:
    """``module``, on ``device``, wrapped to train over the default group:
    every rank takes rank 0's state, then DistributedDataParallel averages
    the gradients after each backward. A DLA-34 step leaves the outer
    trees' ``project`` layers without a gradient: the static graph lets
    DDP learn that set on the first step instead of searching the autograd
    graph for it on every step (``find_unused_parameters``). BN buffers
    need no broadcast, since their moments are the global batch's on every
    rank (``models/layers.py``)."""
    replicate_state(module)
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, init_sync=False, static_graph=True)
