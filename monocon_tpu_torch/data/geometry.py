"""Pure-numpy 3D geometry for the KITTI camera frame.

Behavioral parity with the reference's ``utils/geometry_ops.py`` (corner
ordering, origins, projection conventions), but implemented as stateless,
fully vectorized functions over ``(N, ...)`` arrays — no torch, no per-object
Python loops.

KITTI camera frame: x right, y down, z forward. 3D boxes are
``[x, y, z, l, h, w, ry]`` where dims are (length, height, width) and ``ry``
rotates about the y (vertical) axis.

A copy of ``monocon_tpu/data/geometry.py``.
"""

from __future__ import annotations

import numpy as np

# Corner ordering template. Matches the reference layout
# (utils/geometry_ops.py:96-124): unravel_index order re-indexed by
# [0, 1, 3, 2, 4, 5, 7, 6] so consecutive corners trace each face.
_CORNER_ORDER = np.array([0, 1, 3, 2, 4, 5, 7, 6])


def corners_template(origin=(0.5, 1.0, 0.5)) -> np.ndarray:
    """Unit-box corner offsets, shape (8, 3), relative to ``origin``."""
    corners = np.stack(np.unravel_index(np.arange(8), [2, 2, 2]), axis=1)
    corners = corners[_CORNER_ORDER].astype(np.float64)
    return corners - np.asarray(origin, dtype=np.float64)


def rotation_y_matrices(angles: np.ndarray) -> np.ndarray:
    """Rotation matrices about the camera y axis. (N,) -> (N, 3, 3)."""
    angles = np.asarray(angles)
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    # Row-major matrices applied as p @ R_T (see boxes3d_to_corners).
    rot = np.stack(
        [
            np.stack([c, zeros, s], axis=-1),
            np.stack([zeros, ones, zeros], axis=-1),
            np.stack([-s, zeros, c], axis=-1),
        ],
        axis=-2,
    )
    return rot


def boxes3d_to_corners(
    centers: np.ndarray,
    dims_lhw: np.ndarray,
    rys: np.ndarray,
    origin=(0.5, 1.0, 0.5),
) -> np.ndarray:
    """3D boxes -> 8 corners in camera coordinates.

    Parity: reference ``center_to_corner_box3d`` (utils/geometry_ops.py:166)
    with axis=1.

    Args:
        centers: (N, 3) box reference points.
        dims_lhw: (N, 3) (l, h, w) = sizes along (x, y, z) before rotation.
        rys: (N,) yaw about y.
        origin: reference point location inside the unit box;
            (0.5, 1.0, 0.5) = bottom center (KITTI label convention),
            (0.5, 0.5, 0.5) = gravity center.

    Returns:
        (N, 8, 3) corners.
    """
    centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
    dims_lhw = np.atleast_2d(np.asarray(dims_lhw, dtype=np.float64))
    rys = np.atleast_1d(np.asarray(rys, dtype=np.float64))

    template = corners_template(origin)  # (8, 3)
    corners = dims_lhw[:, None, :] * template[None, :, :]  # (N, 8, 3)
    # Row-vector rotation: p' = p @ R^T, with R as returned above this equals
    # the reference einsum('aij,jka->aik') contraction.
    rot = rotation_y_matrices(rys)  # (N, 3, 3)
    corners = np.einsum("nij,nkj->nik", corners, rot)
    return corners + centers[:, None, :]


def expand_projection(proj: np.ndarray) -> np.ndarray:
    """Pad a 3x3 / 3x4 / 4x4 projection matrix to 4x4."""
    viewpad = np.eye(4, dtype=np.float64)
    viewpad[: proj.shape[0], : proj.shape[1]] = proj
    return viewpad


def project_to_image(
    points: np.ndarray, proj: np.ndarray, with_depth: bool = False
) -> np.ndarray:
    """Project camera-frame points to pixel coordinates.

    Parity: reference ``points_cam2img`` (utils/geometry_ops.py:48).

    Args:
        points: (..., 3) points in the camera frame.
        proj: (3, 4) (or 3x3 / 4x4) projection matrix.
        with_depth: append the homogeneous depth as a third channel.

    Returns:
        (..., 2) or (..., 3) pixel coordinates.
    """
    points = np.asarray(points, dtype=np.float64)
    proj4 = expand_projection(np.asarray(proj, dtype=np.float64))
    homo = np.concatenate([points, np.ones_like(points[..., :1])], axis=-1)
    projected = homo @ proj4.T
    uv = projected[..., :2] / projected[..., 2:3]
    if with_depth:
        return np.concatenate([uv, projected[..., 2:3]], axis=-1)
    return uv


def inverse_rigid_transform(tr: np.ndarray) -> np.ndarray:
    """Invert a (3, 4) rigid [R|t] transform."""
    inv = np.zeros_like(tr)
    inv[:3, :3] = tr[:3, :3].T
    inv[:3, 3] = -tr[:3, :3].T @ tr[:3, 3]
    return inv


def corners_to_image_bbox(
    corners: np.ndarray, proj: np.ndarray
) -> np.ndarray:
    """Project (N, 8, 3) corners and take the axis-aligned 2D hull.

    Returns (N, 4) [x1, y1, x2, y2].
    """
    uv = project_to_image(corners, proj)  # (N, 8, 2)
    min_xy = uv.min(axis=1)
    max_xy = uv.max(axis=1)
    return np.concatenate([min_xy, max_xy], axis=-1)


def alpha_from_ry(locs: np.ndarray, rys: np.ndarray) -> np.ndarray:
    """Observation angle alpha = ry - atan2(x, z). (N,3),(N,)->(N,)."""
    locs = np.atleast_2d(locs)
    return np.asarray(rys) - np.arctan2(locs[:, 0], locs[:, 2])


def ry_from_alpha(locs: np.ndarray, alphas: np.ndarray) -> np.ndarray:
    """Inverse of :func:`alpha_from_ry`."""
    locs = np.atleast_2d(locs)
    return np.asarray(alphas) + np.arctan2(locs[:, 0], locs[:, 2])
