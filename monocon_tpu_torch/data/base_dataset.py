"""KITTI mono-3D dataset base: file resolution, raw loading, GT collection.

A copy of ``monocon_tpu/data/base_dataset.py`` (reference
``dataset/base_dataset.py``), except that images are read by the port's
own PNG reader (``png.py``), bit-equal to OpenCV's, since the port runs
where no image library is installed. The decoded-image cache
(``DATA.IMAGE_CACHE``, ``image_cache.py``) is wired in as there. The
standard KITTI 3D split ID lists
(train 3712 / val 3769 / trainval 7481 / test 7518) ship as packed data in
``resources/kitti_splits.json.gz``; a custom ``ImageSets`` directory in the
KITTI root takes precedence when present.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .calib import Calibration
from .image_cache import resolve_image_cache
from .labels import ObjectLabels
from .png import read_png

_RESOURCE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "resources")
SPLITS = ("train", "val", "trainval", "test")


def load_split_ids(split: str, base_root: Optional[str] = None) -> List[str]:
    """Zero-padded sample IDs for a split. A user-provided
    ``{base_root}/ImageSets/{split}.txt`` wins over the packed defaults."""
    if base_root is not None:
        custom = os.path.join(base_root, "ImageSets", f"{split}.txt")
        if os.path.isfile(custom):
            with open(custom) as f:
                return [line.strip() for line in f if line.strip()]
    with gzip.open(os.path.join(_RESOURCE_DIR, "kitti_splits.json.gz"), "rt") as f:
        packed = json.load(f)
    return [f"{i:06d}" for i in packed[split]]


class KittiMono3D:
    """Resolves image/calib/label files for a split and loads raw samples."""

    def __init__(self, base_root: str, split: str, pad_divisor: int = 32,
                 image_cache: str = ""):
        assert os.path.isdir(base_root), base_root
        assert split in SPLITS, split
        self.base_root = base_root
        self.split = split
        self.pad_divisor = pad_divisor
        # Decoded-uint8 write-through cache (cfg.DATA.IMAGE_CACHE): the PNG
        # is decoded once, later epochs read the array back.
        self.image_cache = resolve_image_cache(image_cache, base_root, split)
        self.sample_ids = load_split_ids(split, base_root)
        sub = "testing" if split == "test" else "training"
        self.image_dir = os.path.join(base_root, sub, "image_2")
        self.calib_dir = os.path.join(base_root, sub, "calib")
        self.label_dir = (
            os.path.join(base_root, sub, "label_2") if split != "test" else None
        )
        self._gt_annos: Optional[List[Dict[str, np.ndarray]]] = None

    def __len__(self) -> int:
        return len(self.sample_ids)

    def image_path(self, idx: int) -> str:
        return os.path.join(self.image_dir, f"{self.sample_ids[idx]}.png")

    def load_image(self, idx: int) -> Tuple[np.ndarray, Dict[str, Any]]:
        path = self.image_path(idx)
        key = self.sample_ids[idx]
        rgb = (self.image_cache.get(key)
               if self.image_cache is not None else None)
        if rgb is None:
            rgb = read_png(path)
            if self.image_cache is not None:
                self.image_cache.put(key, rgb)
        metas = {
            "idx": idx,
            "split": self.split,
            "sample_idx": int(self.sample_ids[idx]),
            "image_path": path,
            "ori_shape": rgb.shape[:2],
        }
        return rgb, metas

    def load_calib(self, idx: int) -> Calibration:
        return Calibration.from_file(
            os.path.join(self.calib_dir, f"{self.sample_ids[idx]}.txt")
        )

    def load_label(self, idx: int) -> ObjectLabels:
        assert self.label_dir is not None, "test split has no labels"
        return ObjectLabels.from_file(
            os.path.join(self.label_dir, f"{self.sample_ids[idx]}.txt")
        )

    def collect_gt_annos(self) -> List[Dict[str, np.ndarray]]:
        """All-objects (incl. DontCare) annotation dicts for the evaluator
        (reference collect_gt_infos, base_dataset.py:86-117)."""
        if self._gt_annos is None:
            self._gt_annos = [
                self.load_label(i).info_dict() for i in range(len(self))
            ]
        return self._gt_annos

    def evaluate(
        self,
        kitti_format_results: Dict[str, List[Dict[str, np.ndarray]]],
        eval_classes=("Pedestrian", "Cyclist", "Car"),
        eval_types=("bbox", "bev", "3d"),
        verbose: bool = True,
        save_path: Optional[str] = None,
    ) -> Dict[str, float]:
        """Run official KITTI AP evaluation on collected results.

        Parity: reference ``BaseKITTIMono3DDataset.evaluate``
        (base_dataset.py:119-152): the 2D branch is forced to
        eval_types=['bbox'].
        """
        from ..eval import kitti_eval  # local import: keeps data import light

        gt_annos = self.collect_gt_annos()
        ap_dict: Dict[str, float] = {}
        for name, result in kitti_format_results.items():
            types = ["bbox"] if "2d" in name else list(eval_types)
            result_str, result_dict = kitti_eval(
                gt_annos, result, current_classes=list(eval_classes),
                eval_types=types,
            )
            for ap_type, ap_value in result_dict.items():
                ap_dict[f"{name}/{ap_type}"] = float(f"{ap_value:.4f}")
            if verbose and "2d" not in name:
                print(result_str)
        if save_path is not None:
            with open(save_path, "w") as f:
                json.dump(ap_dict, f)
        return ap_dict
