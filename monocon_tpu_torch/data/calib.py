"""KITTI calibration parsing and manipulation (host-side, numpy).

Behavioral parity with the reference ``KITTICalibration``
(utils/data_classes.py:10-111): same file format, same derived intrinsics,
same rescale semantics. Implemented as a small dataclass over numpy arrays.

A copy of ``monocon_tpu/data/calib.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from .geometry import expand_projection, inverse_rigid_transform


@dataclass
class Calibration:
    P0: np.ndarray
    P1: np.ndarray
    P2: np.ndarray
    P3: np.ndarray
    R0: np.ndarray
    V2C: np.ndarray  # velodyne -> cam0 rigid transform (3, 4)
    I2V: np.ndarray  # imu -> velodyne rigid transform (3, 4)
    C2V: np.ndarray = field(init=False)
    V2I: np.ndarray = field(init=False)

    def __post_init__(self) -> None:
        self.C2V = inverse_rigid_transform(self.V2C)
        self.V2I = inverse_rigid_transform(self.I2V)

    # Derived intrinsics from P2 (reference: utils/data_classes.py:30-36).
    @property
    def cu(self) -> float:
        return float(self.P2[0, 2])

    @property
    def cv(self) -> float:
        return float(self.P2[1, 2])

    @property
    def fu(self) -> float:
        return float(self.P2[0, 0])

    @property
    def fv(self) -> float:
        return float(self.P2[1, 1])

    @property
    def tx(self) -> float:
        return float(self.P2[0, 3] / (-self.fu))

    @property
    def ty(self) -> float:
        return float(self.P2[1, 3] / (-self.fv))

    def copy(self) -> "Calibration":
        return Calibration(
            P0=self.P0.copy(),
            P1=self.P1.copy(),
            P2=self.P2.copy(),
            P3=self.P3.copy(),
            R0=self.R0.copy(),
            V2C=self.V2C.copy(),
            I2V=self.I2V.copy(),
        )

    def rescale(self, scale_x: float = 1.0, scale_y: float = 1.0) -> None:
        """In-place rescale of all P matrices for an image resize.

        Parity: reference ``KITTICalibration.rescale``
        (utils/data_classes.py:93-110).
        """
        for mat in (self.P0, self.P1, self.P2, self.P3):
            mat[0, [0, 2, 3]] *= scale_x
            mat[1, [1, 2, 3]] *= scale_y

    def cam_shift_x(self, src_cam: int, dst_cam: int) -> float:
        """Horizontal translation (in meters) moving a point expressed
        relative to ``src_cam`` into ``dst_cam``'s frame.

        Parity: reference ``KITTISingleObject.convert_cam``
        (utils/data_classes.py:191-198).
        """
        src = getattr(self, f"P{src_cam}")
        dst = getattr(self, f"P{dst_cam}")
        return float((dst[0, 3] - src[0, 3]) / dst[0, 0])

    def get_info_dict(self) -> Dict[str, np.ndarray]:
        """4x4-padded matrices for the evaluator (reference
        ``get_info_dict``, utils/data_classes.py:82-90)."""
        return {
            "P0": expand_projection(self.P0),
            "P1": expand_projection(self.P1),
            "P2": expand_projection(self.P2),
            "P3": expand_projection(self.P3),
            "R0_rect": expand_projection(self.R0),
            "Tr_velo_to_cam": expand_projection(self.V2C),
            "Tr_imu_to_velo": expand_projection(self.I2V),
        }

    @staticmethod
    def from_file(path: str) -> "Calibration":
        with open(path) as f:
            lines = f.readlines()

        def row(i: int) -> np.ndarray:
            return np.array(lines[i].strip().split(" ")[1:], dtype=np.float32)

        return Calibration(
            P0=row(0).reshape(3, 4),
            P1=row(1).reshape(3, 4),
            P2=row(2).reshape(3, 4),
            P3=row(3).reshape(3, 4),
            R0=row(4).reshape(3, 3),
            V2C=row(5).reshape(3, 4),
            I2V=row(6).reshape(3, 4),
        )

    @staticmethod
    def from_p2(p2: np.ndarray) -> "Calibration":
        """Build a minimal calibration carrying only P2 (raw-sequence use,
        reference ``SimpleCalib``, dataset/kitti_raw_dataset.py:24-26)."""
        eye34 = np.eye(4, dtype=np.float32)[:3]
        return Calibration(
            P0=eye34.copy(),
            P1=eye34.copy(),
            P2=np.asarray(p2, dtype=np.float32).reshape(3, 4),
            P3=eye34.copy(),
            R0=np.eye(3, dtype=np.float32),
            V2C=eye34.copy(),
            I2V=eye34.copy(),
        )
