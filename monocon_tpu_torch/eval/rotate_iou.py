"""Rotated-rectangle overlap of aligned box pairs, on the C++ kernel.

The JAX package's ``monocon_tpu/eval/rotate_iou.py`` computes it in numpy
(an exact Sutherland–Hodgman clip over all pairs at once) and holds its C++
kernel, ``native.rotate_pairs_native``, to those bits. The port keeps only
the kernel; its tests hold it against the JAX package's numpy version.

Box format: (cx, cy, w, h, angle) with the reference's *clockwise* rotation
convention (rotate_iou.py:200-223). criterion: -1 = IoU, 0 = inter/area2,
1 = inter/area1 (the reference's argument-order quirk), 2 = raw
intersection area.
"""

from __future__ import annotations

import numpy as np


def rotate_iou_pairs(
    boxes: np.ndarray, qboxes: np.ndarray, criterion: int = -1
) -> np.ndarray:
    """Elementwise rotated overlap for P aligned pairs: (P,5),(P,5)->(P,)
    float32. Used to batch every image's overlap matrix of an evaluation
    into one kernel call (protocol.compute_overlaps_all)."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), dtype=np.float32)

    from .native import rotate_pairs_native

    # Areas multiply in the input dtype, THEN widen (the JAX package's
    # numpy path does so) — keep that quirk out of the kernel.
    return rotate_pairs_native(
        boxes.astype(np.float64), qboxes.astype(np.float64),
        (boxes[:, 2] * boxes[:, 3]).astype(np.float64),
        (qboxes[:, 2] * qboxes[:, 3]).astype(np.float64),
        criterion,
    )
