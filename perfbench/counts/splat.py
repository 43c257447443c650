"""The least time of the two splat calls of a training step (the centre
heatmap and the keypoint heatmap), from the batch's labels.

Each input is read once and each heatmap written once; against that, the
operations that the valid instances need on the pixels of their squares
that lie on the map, 9 float32 operations a pixel (two offsets, two
squares, an add, a multiply, the exp, the floor test and the max), at the
float32 rate outside the tensor cores. The label arithmetic is the
targets' (centres and keypoints on the stride-4 grid, truncated; the
CenterNet radius at min overlap 0.3)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

OPS_PER_PIXEL = 9
F32_OPS_PER_S = 66.9e12
NUM_KPTS = 9
NUM_CLASSES = 3
# Bytes a call reads per instance: (x, y) and radius and channel as int32,
# and the valid flag.
INPUT_BYTES = 4 * 4 + 1


def _radius(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    ov = 0.3
    b1, c1 = h + w, w * h * (1 - ov) / (1 + ov)
    r1 = (b1 - np.sqrt(np.maximum(b1 * b1 - 4 * c1, 0))) / 2
    b2, c2 = 2 * (h + w), (1 - ov) * w * h
    r2 = (b2 - np.sqrt(np.maximum(b2 * b2 - 16 * c2, 0))) / 8
    a3, b3, c3 = 4 * ov, -2 * ov * (h + w), (ov - 1) * w * h
    r3 = (b3 + np.sqrt(np.maximum(b3 * b3 - 4 * a3 * c3, 0))) / (2 * a3)
    return np.maximum(np.trunc(np.minimum(np.minimum(r1, r2), r3)), 0)


def _pixels(x, y, r, valid, h, w) -> int:
    cols = np.clip(x + r, -1, w - 1) - np.clip(x - r, 0, w) + 1
    rows = np.clip(y + r, -1, h - 1) - np.clip(y - r, 0, h) + 1
    return int((np.maximum(cols, 0) * np.maximum(rows, 0) * valid).sum())


def step_work(label: Dict[str, np.ndarray], pad_hw: Tuple[int, int]
              ) -> Tuple[float, float]:
    """(bytes, operations) of one step's two splat calls."""
    ph, pw = pad_hw
    fh, fw = ph // 4, pw // 4
    hr, wr = fh / ph, fw / pw
    box = label["gt_bboxes"].astype(np.float32)
    mask = label["mask"] > 0
    b, o = mask.shape
    cx = ((box[..., 0] + box[..., 2]) * wr / 2).astype(np.int32)
    cy = ((box[..., 1] + box[..., 3]) * hr / 2).astype(np.int32)
    r = _radius((box[..., 3] - box[..., 1]) * hr,
                (box[..., 2] - box[..., 0]) * wr)
    kp = label["gt_kpts_2d"].reshape(b, o, NUM_KPTS, 2)
    kx = np.trunc(kp[..., 0] * wr).astype(np.int32)
    ky = np.trunc(kp[..., 1] * hr).astype(np.int32)
    on = ((label["gt_kpts_valid_mask"] >= 1) & mask[..., None]
          & (kx >= 0) & (kx < fw) & (ky >= 0) & (ky < fh))
    pixels = (_pixels(cx, cy, r, mask, fh, fw)
              + _pixels(kx, ky, r[..., None], on, fh, fw))
    nbytes = (b * o * (1 + NUM_KPTS) * INPUT_BYTES
              + b * (NUM_CLASSES + NUM_KPTS) * fh * fw * 4)
    return float(nbytes), float(pixels * OPS_PER_PIXEL)


def bound_seconds(nbytes: float, ops: float, bytes_per_s: float
                  ) -> Tuple[float, str]:
    """(least seconds, what bounds them: "bytes" or "operations")."""
    t_bytes, t_ops = nbytes / bytes_per_s, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
