"""Data parallelism over the ranks of a process group.

The data-parallel part of ``monocon_tpu/parallel/mesh.py``. There a mesh's
``data`` axis splits each global batch over the devices, and XLA inserts
the gradient and BatchNorm all-reduces. Here each rank is one process and
one device: it loads its own rows of every global batch
(:func:`rank_rows`), starts from rank 0's state (:func:`replicate_state`),
and ``DistributedDataParallel`` with the synced BN moments of
``models/layers.py`` and the global loss sums of
``engine/train_step.py`` stands in for the all-reduces.

The JAX package's second axis, ``TPU.SPATIAL_SHARDS = S > 1``, splits the
image height over devices, and GSPMD inserts the halo exchanges from one
sharding annotation. Here it is a layout of the ranks (:class:`SpatialLayout`):
``D x S`` processes, rank ``r = d * S + s`` as the JAX package's
``np.array(devices).reshape(-1, spatial)`` orders its mesh; rank ``r``
loads the rows of data shard ``d`` and holds band ``s`` of the canvas
(:func:`band_rows`). The halo exchanges, the pooling over the space
group and the gathered head maps are written out in ``parallel/spatial.py``
and ``models/``. :func:`max_safe_spatial_shards` and
:func:`validate_spatial_shards` are copies of the JAX package's, so that
the port refuses what the JAX engine refuses: explicit halos are exact at
any band height, but the envelope is part of the config's contract.
"""

from __future__ import annotations

import dataclasses
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


# The deepest feature map's stride: bands are whole rows of it, so that
# they stay aligned through the five stride-2 stages.
BAND_STRIDE = 32


def max_safe_spatial_shards(pad_h: int) -> int:
    """Copy of ``monocon_tpu/parallel/mesh.py::max_safe_spatial_shards``:
    the JAX package's measured envelope for GSPMD's halo exchange. Every
    3x3 stride-2 conv keeps at least 3 input rows a shard on the H/16 map,
    and every 3x3 stride-1 conv at least 2 on the H/32 map."""
    return max(1, min((pad_h // 16) // 3, (pad_h // 32) // 2))


def validate_spatial_shards(pad_h: int, spatial: int) -> None:
    """Raise unless ``spatial`` divides a ``pad_h`` canvas and stays within
    :func:`max_safe_spatial_shards`, as the JAX package's copy raises."""
    if spatial <= 1:
        return
    if pad_h % spatial != 0:
        raise ValueError(
            f"TPU.SPATIAL_SHARDS={spatial} does not divide the batch "
            f"canvas height {pad_h}")
    safe = max_safe_spatial_shards(pad_h)
    if spatial > safe:
        raise ValueError(
            f"TPU.SPATIAL_SHARDS={spatial} exceeds the numerically safe "
            f"limit {safe} for canvas height {pad_h}: below (window//2 + "
            f"stride) rows per shard, GSPMD's conv halo exchange "
            f"miscomputes in the JAX package (monocon_tpu/parallel/"
            f"mesh.py), and the port keeps its envelope. Reduce the shard "
            f"count or raise TPU.PAD_HW[0].")


def band_rows(pad_h: int, spatial: int, index: int) -> Tuple[int, int]:
    """The canvas rows ``[start, stop)`` of band ``index`` of ``spatial``.

    The ``pad_h // 32`` rows of the deepest map are split as evenly as they
    go, the first bands taking one more, and scaled back to image rows: a
    band starts on a row of every level. 384 over 2 gives 192/192; 320
    over 4 gives deep rows 3/3/2/2, image rows 96/96/64/64; 288 over 4
    gives 3/2/2/2, where a split by the ceiling would leave the last band
    empty."""
    if pad_h % BAND_STRIDE:
        raise ValueError(f"a canvas height of {pad_h} is not a multiple "
                         f"of the deepest stride {BAND_STRIDE}")
    deep = pad_h // BAND_STRIDE
    if not 0 < spatial <= deep:
        raise ValueError(f"{deep} rows of the deepest map do not split "
                         f"into {spatial} bands")
    base, extra = divmod(deep, spatial)
    start = index * base + min(index, extra)
    stop = start + base + (index < extra)
    return start * BAND_STRIDE, stop * BAND_STRIDE


@dataclasses.dataclass(frozen=True)
class SpatialLayout:
    """This rank's place in a ``data_shards x spatial`` layout of the
    default group: rank ``r`` is data shard ``r // spatial`` and band
    ``r % spatial`` of a ``pad_h`` canvas. ``space_group`` holds the ranks
    of this data shard, ``data_group`` those of this band (None when it
    would hold this rank alone)."""

    data_shards: int
    spatial: int
    rank: int
    pad_h: int
    space_group: Optional[dist.ProcessGroup]
    data_group: Optional[dist.ProcessGroup]

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def space_index(self) -> int:
        return self.rank % self.spatial

    @property
    def bands(self) -> List[Tuple[int, int]]:
        """Every band's canvas rows, in space order."""
        return [band_rows(self.pad_h, self.spatial, s)
                for s in range(self.spatial)]

    @property
    def band(self) -> Tuple[int, int]:
        """This rank's canvas rows."""
        return band_rows(self.pad_h, self.spatial, self.space_index)

    @property
    def prev_rank(self) -> Optional[int]:
        """The rank of the band above, or None at the canvas's top."""
        return self.rank - 1 if self.space_index > 0 else None

    @property
    def next_rank(self) -> Optional[int]:
        """The rank of the band below, or None at the canvas's bottom."""
        return (self.rank + 1 if self.space_index < self.spatial - 1
                else None)


def spatial_layout(pad_h: int, spatial: int) -> SpatialLayout:
    """This rank's :class:`SpatialLayout` over the default group, whose
    size must be a multiple of ``spatial``. Every rank must call it, in
    the same order as its other ``new_group`` calls: it makes the space
    groups and, with more than one data shard, the data groups."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if world % spatial:
        raise ValueError(
            f"TPU.SPATIAL_SHARDS={spatial} needs a multiple of {spatial} "
            f"ranks; the process group has {world}")
    band_rows(pad_h, spatial, 0)       # the canvas splits
    shards = world // spatial
    space_group = data_group = None
    for d in range(shards):
        group = dist.new_group([d * spatial + s for s in range(spatial)])
        if rank // spatial == d:
            space_group = group
    if shards > 1:
        for s in range(spatial):
            group = dist.new_group([d * spatial + s for d in range(shards)])
            if rank % spatial == s:
                data_group = group
    return SpatialLayout(shards, spatial, rank, pad_h, space_group,
                         data_group)
