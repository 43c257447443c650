"""On-device normalisation of raw uint8 image batches.

Port of ``monocon_tpu/ops/image_norm.py``: a uint8 batch becomes
``(x - mean) * (1 / std)`` in float32 with the ImageNet constants, then is
zeroed outside each sample's true ``[:h, :w]`` extent; a float batch is
taken as normalised already and passes through.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# The ImageNet mean and std of the host Normalize transform
# (monocon_tpu/data/transforms.py), in the same float32 values.
IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
_INV_STD = 1.0 / np.asarray(IMAGENET_STD, np.float32)


def normalize_if_raw(image: torch.Tensor,
                     hw: Optional[torch.Tensor] = None,
                     row0: int = 0) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalised float32; floats pass through.

    ``hw`` (B, 2) gives each sample's true (h, w) before padding; the
    padded border becomes exactly 0.0, as the float transport's is.
    ``image`` holds the canvas's rows from ``row0`` on (a band of the
    image height split over ranks)."""
    if image.dtype != torch.uint8:
        return image
    mean = torch.from_numpy(_MEAN).to(image.device)
    inv_std = torch.from_numpy(_INV_STD).to(image.device)
    out = (image.to(torch.float32) - mean) * inv_std
    if hw is not None:
        hw = hw.to(image.device)
        rows = torch.arange(row0, row0 + image.shape[1], device=image.device)
        h_in = rows < hw[:, 0, None]
        w_in = torch.arange(image.shape[2], device=image.device) < hw[:, 1, None]
        out = out * (h_in[:, :, None] & w_in[:, None, :])[..., None]
    return out
