"""KITTI raw drive sequences for video inference.

A copy of ``monocon_tpu/data/kitti_raw.py`` (reference
``dataset/kitti_raw_dataset.py``): globs the frames of a drive, parses
``calib_cam_to_cam.txt`` for P_rect_02, keeps the unnormalized frame for
video export, fakes the batch dim.

Frames are read with :func:`~monocon_tpu_torch.data.png.read_png`: KITTI
raw's ``image_02/data`` frames are 8-bit RGB PNGs. The card's machine has
no JPEG decoder, so any other extension is refused when the dataset is
made, and :meth:`KITTIRawDataset.frame_shape` reads the PNG header only.
``__getitem__`` opens and decodes its own file, so it is safe to call from
the threads of ``utils.streaming.pipelined_frames``.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional

import numpy as np

from .calib import Calibration
from .png import SIGNATURE, read_png
from .transforms import Compose, default_raw_transforms


def parse_cam_to_cam(path: str) -> np.ndarray:
    """Extract P_rect_02 (3, 4) from a KITTI-raw calib_cam_to_cam.txt."""
    with open(path) as f:
        for line in f:
            if line.startswith("P_rect_02"):
                vals = np.array(line.split(":")[1].split(), dtype=np.float32)
                return vals.reshape(3, 4)
    raise ValueError(f"P_rect_02 not found in {path}")


class KITTIRawDataset:
    def __init__(
        self,
        image_dir: str,
        calib_file: str,
        transforms: Optional[list] = None,
        img_extension: str = "png",
    ):
        if img_extension.lower() != "png":
            raise ValueError(
                f"img_extension={img_extension!r}: the port reads PNG frames "
                "only (KITTI raw's are PNG); the GPU machine it runs on has "
                "no JPEG decoder, so convert the frames to PNG first")
        pattern = os.path.join(image_dir, f"*.{img_extension}")
        self.image_files = sorted(glob.glob(pattern))
        if not self.image_files:
            raise FileNotFoundError(f"no frames matching {pattern}")
        self.calib = Calibration.from_p2(parse_cam_to_cam(calib_file))
        self.transforms = Compose(
            default_raw_transforms() if transforms is None else transforms
        )

    def __len__(self) -> int:
        return len(self.image_files)

    def frame_shape(self, idx: int) -> tuple:
        """Raw (h, w) of frame ``idx`` from its PNG header (IHDR), with no
        decode, so that checking a whole drive for one resolution is
        cheap."""
        path = self.image_files[idx]
        with open(path, "rb") as f:
            head = f.read(24)
        if head[:8] != SIGNATURE or head[12:16] != b"IHDR":
            raise ValueError(f"{path}: not a PNG file")
        return (int.from_bytes(head[20:24], "big"),
                int.from_bytes(head[16:20], "big"))

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        path = self.image_files[idx]
        rgb = read_png(path)
        sample = {
            "img": rgb,
            "img_metas": {
                "idx": idx,
                "sample_idx": idx,
                "image_path": path,
                "ori_shape": rgb.shape[:2],
            },
            "calib": self.calib.copy(),
            "label": None,
        }
        sample = self.transforms(sample)
        # Fake batch dimension (reference Convert_3D_to_4D,
        # default_transforms.py:460-479).
        sample["img"] = sample["img"][None]
        if "ori_img" in sample:
            sample["ori_img"] = sample["ori_img"][None]
        sample["img_metas"] = {k: [v] for k, v in sample["img_metas"].items()}
        sample["calib"] = [sample["calib"]]
        return sample
