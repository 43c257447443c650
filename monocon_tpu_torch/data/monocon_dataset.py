"""MonoCon train/val dataset: per-sample assembly of fixed-shape labels.

A copy of ``monocon_tpu/data/monocon_dataset.py``. Parity: reference
``dataset/monocon_dataset.py`` — object filters
(occlusion/truncation/height/depth), cam0->cam2 + global->local yaw
conversion, projected center/keypoints, padding to ``max_objs`` slots with
a mask — but vectorized over objects instead of a per-object Python loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .base_dataset import KittiMono3D
from .labels import (
    projected_centers_3d,
    projected_keypoints,
    shift_cam,
    yaw_global_to_local,
)
from .transforms import Compose, default_test_transforms, default_train_transforms

DEFAULT_FILTER_CONFIG = {
    "min_height": 25,
    "min_depth": 2,
    "max_depth": 65,
    "max_truncation": 0.5,
    "max_occlusion": 2,
}

LABEL_KEYS_2D = ("gt_bboxes", "gt_labels")
NUM_KPTS = 9


def empty_labels(max_objs: int) -> Dict[str, np.ndarray]:
    """Fixed-shape label container (reference _create_empty_labels,
    monocon_dataset.py:160-171)."""
    return {
        "gt_bboxes": np.zeros((max_objs, 4), np.float32),
        "gt_labels": np.zeros(max_objs, np.float32),
        "gt_bboxes_3d": np.zeros((max_objs, 7), np.float32),
        "gt_labels_3d": np.zeros(max_objs, np.float32),
        "centers2d": np.zeros((max_objs, 2), np.float32),
        "depths": np.zeros(max_objs, np.float32),
        "gt_kpts_2d": np.zeros((max_objs, NUM_KPTS * 2), np.float32),
        "gt_kpts_valid_mask": np.zeros((max_objs, NUM_KPTS), np.float32),
        "mask": np.zeros(max_objs, bool),
    }


class MonoConDataset(KittiMono3D):
    def __init__(
        self,
        base_root: str,
        split: str,
        max_objs: int = 30,
        transforms: Optional[List] = None,
        filter_configs: Optional[Dict[str, Any]] = None,
        **kwargs,
    ):
        super().__init__(base_root, split, **kwargs)
        self.max_objs = max_objs
        if transforms is None:
            transforms = (
                default_train_transforms() if split == "train"
                else default_test_transforms()
            )
        self.transforms = Compose(transforms)
        cfg = dict(DEFAULT_FILTER_CONFIG)
        if filter_configs:
            unknown = set(filter_configs) - set(cfg)
            assert not unknown, f"unknown filter keys: {unknown}"
            cfg.update(filter_configs)
        self.filter_configs = cfg

    def get_sample(
        self, idx: int, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, Any]:
        image, metas = self.load_image(idx)
        calib = self.load_calib(idx)
        labels = empty_labels(self.max_objs)
        if self.label_dir is None:
            # test split: inference-only samples with empty labels
            raw = None
            n = 0
        else:
            raw = self.load_label(idx).drop_dontcare()
            n = min(len(raw), self.max_objs)
        if n > 0:
            raw = raw.select(np.arange(len(raw)) < self.max_objs)
            cfg = self.filter_configs

            # cam0 -> cam2 and global -> local yaw at the cam2 location
            # (reference monocon_dataset.py:84-85; the yaw offset is
            # evaluated after the cam shift).
            loc2 = shift_cam(raw.loc, calib, 0, 2)
            alpha_local = yaw_global_to_local(raw.ry, loc2)

            # Projections use the KITTI-native cam0/global state
            # (see labels.projected_centers_3d docstring).
            centers = projected_centers_3d(raw.loc, raw.dim_lhw, calib)
            kpts = projected_keypoints(raw.loc, raw.dim_lhw, raw.ry, calib)

            h, w = metas["ori_shape"]
            bbox_h = raw.bbox[:, 3] - raw.bbox[:, 1]
            keep = (
                (raw.occluded <= cfg["max_occlusion"])
                & (raw.truncated <= cfg["max_truncation"])
                & (bbox_h >= cfg["min_height"])
                & (centers[:, 2] >= cfg["min_depth"])
                & (centers[:, 2] <= cfg["max_depth"])
                & (centers[:, 2] > 0)  # projected_kpts guard (depth <= 0)
            )

            # Keypoint visibility: upgraded to 2 if inside the image;
            # outside the image the projected-validity flag (1 = corner in
            # front of the camera, 0 = behind) is kept as-is
            # (monocon_dataset.py:128-133).
            in_image = (
                (kpts[..., 0] >= 0) & (kpts[..., 0] <= w)
                & (kpts[..., 1] >= 0) & (kpts[..., 1] <= h)
            )
            vis = np.where(in_image, 2.0, kpts[..., 2])

            sel = np.where(keep)[0]
            m = len(sel)
            if m > 0:
                self._fill_labels(labels, raw, sel, loc2, alpha_local,
                                  centers, kpts, vis)
        sample = {
            "img": image,
            "img_metas": metas,
            "calib": calib,
            "label": labels,
        }
        return self.transforms(sample, rng)

    def _fill_labels(self, labels, raw, sel, loc2, alpha_local, centers,
                     kpts, vis) -> None:
        m = len(sel)
        labels["gt_bboxes"][:m] = raw.bbox[sel]
        labels["gt_labels"][:m] = raw.cls_idx[sel]
        labels["gt_bboxes_3d"][:m] = np.concatenate(
            [loc2[sel], raw.dim_lhw[sel], alpha_local[sel, None]], axis=1
        )
        labels["gt_labels_3d"][:m] = raw.cls_idx[sel]
        labels["centers2d"][:m] = centers[sel, :2]
        labels["depths"][:m] = centers[sel, 2]
        labels["gt_kpts_2d"][:m] = kpts[sel, :, :2].reshape(m, -1)
        labels["gt_kpts_valid_mask"][:m] = vis[sel]
        labels["mask"][:m] = True

    # Sequence protocol for simple iteration (reference __getitem__).
    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.get_sample(idx)
