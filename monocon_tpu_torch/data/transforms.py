"""The evaluation half of the host-side transform pipeline (pure numpy).

A copy of the evaluation transforms of ``monocon_tpu/data/transforms.py``
(reference ``transforms/default_transforms.py``): ``Compose``,
``Normalize``, ``Pad`` and :func:`default_test_transforms`. The training
augmentations and ``QuantizeU8`` come with the training engine (ROADMAP
item 10).

Randomness: every random transform draws from an explicit
``numpy.random.Generator`` passed to ``Compose``.

Sample dict: {'img': (H,W,3) uint8 or float32, 'img_metas': {...},
'calib': Calibration, 'label': {fixed-shape arrays, incl. 'mask'}}.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng if rng is not None else np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class Normalize:
    """(img - mean) / std in 0-255 space (reference
    default_transforms.py:376-407). The original copy the visualizer keeps
    (``keep_origin``) comes with it (ROADMAP item 12)."""

    IMAGENET_MEAN = (123.675, 116.28, 103.53)
    IMAGENET_STD = (58.395, 57.12, 57.375)

    def __init__(self, mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, 3)
        self.std = np.asarray(std, np.float32).reshape(1, 1, 3)
        self.inv_std = (1.0 / self.std).astype(np.float32)

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["img"].astype(np.float32)
        # In-place (img - mean) * (1/std): two passes, no temporaries.
        img -= self.mean
        img *= self.inv_std
        sample["img"] = img
        return sample


class Pad:
    """Zero-pad bottom/right to a multiple of ``size_divisor``; records
    ``pad_shape`` (reference default_transforms.py:410-433)."""

    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, sample: Dict, rng) -> Dict:
        img = sample["img"]
        h, w = img.shape[:2]
        ph = -(-h // self.size_divisor) * self.size_divisor
        pw = -(-w // self.size_divisor) * self.size_divisor
        canvas = np.zeros((ph, pw, img.shape[2]), dtype=img.dtype)
        canvas[:h, :w] = img
        sample["img"] = canvas
        sample["img_metas"]["pad_shape"] = (ph, pw)
        # True pixel extent before zero-fill: the uint8 transport zeroes
        # the border on the device after normalizing (ops.image_norm),
        # making it bit-identical to the float32 transport's 0.0.
        sample["img_metas"]["unpadded_shape"] = (h, w)
        return sample


def default_test_transforms(device_normalize: bool = False) -> List:
    if device_normalize:
        # Eval images are untouched uint8; ship them raw and normalize
        # on the device: the same numerics, 4x fewer bytes.
        return [Pad(32)]
    return [Normalize(), Pad(32)]
