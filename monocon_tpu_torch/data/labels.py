"""KITTI label parsing + per-object geometry, vectorized over objects.

The reference models each annotation as a stateful ``KITTISingleObject``
with in-place coordinate conversions (utils/data_classes.py:116-385). Here a
label file parses into a struct-of-arrays :class:`ObjectLabels`, and every
conversion is a pure vectorized function — no hidden state machine.
Conventions (camera index, yaw frame, center type) are handled explicitly by
the callers.

A copy of ``monocon_tpu/data/labels.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .calib import Calibration
from .geometry import boxes3d_to_corners, project_to_image

CLASS_TO_IDX = {"DontCare": -1, "Pedestrian": 0, "Cyclist": 1, "Car": 2}
IDX_TO_CLASS = {0: "Pedestrian", 1: "Cyclist", 2: "Car"}

# Difficulty levels (reference get_obj_level, utils/data_classes.py:156-173).
LEVEL_DONTCARE, LEVEL_EASY, LEVEL_MODERATE, LEVEL_HARD, LEVEL_UNKNOWN = 0, 1, 2, 3, 4


@dataclass
class ObjectLabels:
    """All annotations of one image as parallel arrays of length N.

    ``loc`` is the KITTI-native bottom-center location in the cam0 frame;
    ``dim_lhw`` is (length, height, width); ``ry`` is the global yaw.
    """

    name: np.ndarray        # (N,) str objects
    cls_idx: np.ndarray     # (N,) int8, -1 = DontCare/unknown
    truncated: np.ndarray   # (N,) float32
    occluded: np.ndarray    # (N,) float32
    alpha: np.ndarray       # (N,) float32
    bbox: np.ndarray        # (N, 4) float32
    dim_lhw: np.ndarray     # (N, 3) float32
    loc: np.ndarray         # (N, 3) float32
    ry: np.ndarray          # (N,) float32
    score: np.ndarray       # (N,) float32

    def __len__(self) -> int:
        return int(self.name.shape[0])

    def select(self, mask: np.ndarray) -> "ObjectLabels":
        return ObjectLabels(
            name=self.name[mask],
            cls_idx=self.cls_idx[mask],
            truncated=self.truncated[mask],
            occluded=self.occluded[mask],
            alpha=self.alpha[mask],
            bbox=self.bbox[mask],
            dim_lhw=self.dim_lhw[mask],
            loc=self.loc[mask],
            ry=self.ry[mask],
            score=self.score[mask],
        )

    def drop_dontcare(self) -> "ObjectLabels":
        return self.select(self.cls_idx >= 0)

    @property
    def levels(self) -> np.ndarray:
        return object_levels(self.bbox, self.truncated, self.occluded)

    def info_dict(self) -> Dict[str, np.ndarray]:
        """Evaluation annotation dict (reference ``KITTIMultiObjects
        .info_dict``, utils/data_classes.py:338-378)."""
        return {
            "name": self.name.copy(),
            "truncated": self.truncated.copy(),
            "occluded": self.occluded.copy(),
            "alpha": self.alpha.copy(),
            "bbox": self.bbox.copy(),
            "dimensions": self.dim_lhw.copy(),
            "location": self.loc.copy(),
            "rotation_y": self.ry.copy(),
            "score": self.score.copy(),
        }

    @staticmethod
    def from_file(path: str) -> "ObjectLabels":
        with open(path) as f:
            lines = [ln.strip().split(" ") for ln in f.readlines() if ln.strip()]
        return parse_label_lines(lines)


def parse_label_lines(lines) -> ObjectLabels:
    n = len(lines)
    name = np.empty(n, dtype=object)
    cls_idx = np.empty(n, dtype=np.int8)
    fields = np.zeros((n, 15), dtype=np.float32)
    for i, parts in enumerate(lines):
        name[i] = parts[0]
        cls_idx[i] = CLASS_TO_IDX.get(parts[0], -1)
        vals = [float(v) for v in parts[1:16]]
        fields[i, : len(vals)] = vals
        if len(parts) < 16:
            fields[i, 14] = -1.0  # no score column
    # KITTI columns: trunc occl alpha x1 y1 x2 y2 h w l x y z ry [score]
    return ObjectLabels(
        name=name,
        cls_idx=cls_idx,
        truncated=fields[:, 0],
        occluded=fields[:, 1],
        alpha=fields[:, 2],
        bbox=fields[:, 3:7].copy(),
        dim_lhw=fields[:, [9, 7, 8]].copy(),  # (l, h, w)
        loc=fields[:, 10:13].copy(),
        ry=fields[:, 13],
        score=fields[:, 14],
    )


def object_levels(
    bbox: np.ndarray, truncated: np.ndarray, occluded: np.ndarray
) -> np.ndarray:
    """KITTI difficulty levels, vectorized (reference get_obj_level)."""
    height = bbox[:, 3] - bbox[:, 1] + 1
    levels = np.full(bbox.shape[0], LEVEL_UNKNOWN, dtype=np.int32)
    hard = (height >= 25) & (truncated <= 0.5) & (occluded <= 2)
    moderate = (height >= 25) & (truncated <= 0.3) & (occluded <= 1)
    easy = (height >= 40) & (truncated <= 0.15) & (occluded <= 0)
    levels[hard] = LEVEL_HARD
    levels[moderate] = LEVEL_MODERATE
    levels[easy] = LEVEL_EASY
    levels[truncated == -1] = LEVEL_DONTCARE
    return levels


def shift_cam(loc: np.ndarray, calib: Calibration, src_cam: int, dst_cam: int) -> np.ndarray:
    """Move bottom-center locations between camera frames (x shift only)."""
    out = loc.copy()
    out[:, 0] += calib.cam_shift_x(src_cam, dst_cam)
    return out


def yaw_global_to_local(ry: np.ndarray, loc: np.ndarray) -> np.ndarray:
    """Global rotation_y -> local (observation-relative) yaw.

    Parity: reference ``convert_yaw`` with src='global'
    (utils/data_classes.py:182-189): ry_local = ry - atan2(x, z), evaluated
    at the object's *current* location.
    """
    return ry - np.arctan2(loc[:, 0], loc[:, 2])


def yaw_local_to_global(ry_local: np.ndarray, loc: np.ndarray) -> np.ndarray:
    return ry_local + np.arctan2(loc[:, 0], loc[:, 2])


def bottom_to_gravity_center(loc: np.ndarray, dim_lhw: np.ndarray) -> np.ndarray:
    """KITTI bottom-center -> box gravity center (camera y points down)."""
    out = loc.copy()
    out[:, 1] -= 0.5 * dim_lhw[:, 1]
    return out


def projected_centers_3d(
    loc_cam0_bottom: np.ndarray, dim_lhw: np.ndarray, calib: Calibration
) -> np.ndarray:
    """Project gravity centers (in cam0, KITTI-native frame) through P2.

    Parity: reference ``projected_center`` (utils/data_classes.py:209-228):
    the location is first expressed in cam0 and converted bottom->gravity
    center, then projected with P2. Returns (N, 3) [u, v, depth].
    """
    gravity = bottom_to_gravity_center(loc_cam0_bottom, dim_lhw)
    return project_to_image(gravity, calib.P2, with_depth=True)


def projected_keypoints(
    loc_cam0_bottom: np.ndarray,
    dim_lhw: np.ndarray,
    ry_global: np.ndarray,
    calib: Calibration,
) -> np.ndarray:
    """Project the 8 box corners + projected 3D center as 9 keypoints.

    Parity: reference ``projected_kpts`` (utils/data_classes.py:231-278).
    Returns (N, 9, 3): [u, v, validity] where validity is 1 for corners in
    front of the camera (z > 0) and the 9th row is the projected center with
    validity 1. Callers must check ``projected_centers_3d`` depth > 0 first
    (the reference returns None there; here the caller masks).
    """
    gravity = bottom_to_gravity_center(loc_cam0_bottom, dim_lhw)
    corners = boxes3d_to_corners(gravity, dim_lhw, ry_global, origin=(0.5, 0.5, 0.5))
    in_front = (corners[:, :, 2] > 0).astype(np.float64)  # (N, 8)
    uv = project_to_image(corners, calib.P2)  # (N, 8, 2)
    corner_kpts = np.concatenate([uv, in_front[..., None]], axis=-1)  # (N, 8, 3)

    centers = project_to_image(gravity, calib.P2, with_depth=True)
    center_kpts = centers.copy()
    center_kpts[:, 2] = 1.0
    return np.concatenate([corner_kpts, center_kpts[:, None, :]], axis=1)
