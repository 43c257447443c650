"""Data parallelism of the PyTorch/CUDA port over processes and GPUs, and
the image height split over ranks."""

from .distributed import (initialize_distributed, launch,
                          launched_by_torchrun, num_processes, rank_and_world,
                          spawn_ranks)
from .mesh import (SpatialLayout, band_rows, data_parallel, data_shards,
                   max_safe_spatial_shards, rank_rows, replicate_state,
                   spatial_layout, validate_spatial_shards)
from .spatial import HaloExchange, gather_rows, spatial_scope

__all__ = [
    "HaloExchange",
    "SpatialLayout",
    "band_rows",
    "data_parallel",
    "data_shards",
    "gather_rows",
    "initialize_distributed",
    "launch",
    "launched_by_torchrun",
    "max_safe_spatial_shards",
    "num_processes",
    "rank_and_world",
    "rank_rows",
    "replicate_state",
    "spatial_layout",
    "spatial_scope",
    "spawn_ranks",
    "validate_spatial_shards",
]
