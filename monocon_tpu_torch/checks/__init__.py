"""Convergence checks of the port: evidence that the detector learns.

Ports of the JAX package's ``scripts/overfit_check.py`` and
``scripts/generalization_check.py``, run as modules:

    python -m monocon_tpu_torch.checks.overfit          # 4 images, 4000 steps
    python -m monocon_tpu_torch.checks.generalization   # 200 / 100 images

Both train on the card unless ``--device`` names another device.
"""

from __future__ import annotations

import shutil
import subprocess

import torch


def device_label(device: torch.device) -> str:
    """The device a result was measured on: for a card, its name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit`` prints them (the
    name alone where ``nvidia-smi`` is missing); else the device type."""
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else (
        torch.cuda.current_device())
    smi = shutil.which("nvidia-smi")
    if smi is not None:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader",
             "-i", str(index)], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    return torch.cuda.get_device_name(index)
