"""Load detector weights from a reference-format ``.pth`` checkpoint.

The port's modules carry the reference's key layout, so a ``.pth`` written
by the reference, or by the JAX package's ``save_torch_checkpoint`` /
``scripts/export_torch_ckpt.py``, loads with no layout transform: unwrap the
container, then ``load_state_dict(strict=True)``. The JAX package's Orbax
checkpoints (directories) need JAX to read; export them to ``.pth`` first.
Saving and resume come with the training engine (ROADMAP item 10).
"""

from __future__ import annotations

import os

import torch
from torch import nn


def load_weights(path: str, model: nn.Module) -> None:
    """Load the ``.pth``/``.pt`` at ``path`` into ``model``, every key
    required. The file holds the reference engine container
    ``{'state_dict': {'model': sd}}``, ``{'model': sd}`` or a bare state
    dict; it is read on the CPU, tensors and plain containers only
    (``weights_only=True``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, as the JAX package's Orbax checkpoints "
            "are; the port reads .pth/.pt files: convert it with "
            "scripts/export_torch_ckpt.py")
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: want a .pth or .pt checkpoint")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
    elif isinstance(state, dict) and "model" in state:
        state = state["model"]
    model.load_state_dict(state, strict=True)
