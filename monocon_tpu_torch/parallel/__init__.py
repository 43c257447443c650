"""Data parallelism of the PyTorch/CUDA port over processes and GPUs."""

from .distributed import (initialize_distributed, launch,
                          launched_by_torchrun, num_processes, rank_and_world,
                          spawn_ranks)
from .mesh import data_parallel, data_shards, rank_rows, replicate_state

__all__ = [
    "data_parallel",
    "data_shards",
    "initialize_distributed",
    "launch",
    "launched_by_torchrun",
    "num_processes",
    "rank_and_world",
    "rank_rows",
    "replicate_state",
    "spawn_ranks",
]
