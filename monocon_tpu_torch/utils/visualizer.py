"""2D / projected-3D / BEV visualization and frame export (host, numpy).

A copy of ``monocon_tpu/utils/visualizer.py`` (reference
``utils/visualizer.py``: translucent 2D boxes, 12-edge 3D wireframes, a
60 m BEV canvas at scale 10 with a polar grid, per-class colors) that
draws with ``utils/draw.py`` where the JAX package calls OpenCV, and
writes PNG files with ``data/png.py``.

``export_as_video`` keeps the JAX package's name and arguments, but the
card's machine has no video encoder: it writes each item as a numbered PNG
sequence (``save_dir/2d/000000.png``, ...), frame by frame on a few
processes, where the JAX package writes ``2d.mp4``, ``3d.mp4`` and
``bev.mp4``. ``fps`` is the rate to give an encoder. PNG sequences have
no size cap (an uncompressed AVI's 32-bit RIFF sizes stop near 4 GB, about
2900 KITTI frames) and read back bit-exact with ``read_png``.
"""

from __future__ import annotations

import functools
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..data.geometry import boxes3d_to_corners, project_to_image
from ..data.png import write_png
from . import draw

CLASSES = ("Pedestrian", "Cyclist", "Car")
CLASS_IDX_TO_COLOR = {0: (255, 0, 0), 1: (0, 255, 0), 2: (0, 0, 255)}

# Wireframe edges over the corner ordering of boxes3d_to_corners
# (reference visualizer.py:117-118).
LINE_INDICES = ((0, 1), (0, 3), (0, 4), (1, 2), (1, 5), (3, 2), (3, 7),
                (4, 5), (4, 7), (2, 6), (5, 6), (6, 7))

BEV_MAX_DIST, BEV_SCALE = 60, 10
# Pixels past a rectangle's corners that its anti-aliased outline reaches.
_OUTLINE_REACH = 3
# Processes of export_as_video, each drawing and writing one plot at a time.
EXPORT_WORKERS = 4
_PLOTS = {"2d": "plot_bboxes_2d", "3d": "plot_bboxes_3d", "bev": "plot_bev"}

@functools.cache
def bev_grid() -> np.ndarray:
    """The BEV canvas's polar grid (7 rays, 4 rings), drawn once, read-only:
    callers copy it."""
    r = BEV_MAX_DIST * BEV_SCALE
    space = np.zeros((r * 2, r * 2, 3), dtype=np.uint8)
    for theta in np.linspace(0, np.pi, 7):
        draw.line(space, (int(r - r * np.cos(theta)),
                          int(r - r * np.sin(theta))), (r, r),
                  (255, 255, 255))
    for radius in np.linspace(0, r, 5)[1:]:
        draw.circle(space, (r, r), int(radius), (255, 255, 255))
    grid = space[:r]
    grid.setflags(write=False)
    return grid


class Visualizer:
    def __init__(
        self,
        dataset,
        vis_format: List[Dict[str, Any]],
        scale_hw: Optional[Sequence[float]] = None,
    ):
        assert len(dataset) == len(vis_format), (
            "dataset length must equal the number of vis results")
        self.dataset = dataset
        self.pred_bbox_2d = [f["img_bbox2d"] for f in vis_format]
        self.pred_bbox_3d = [f["img_bbox"] for f in vis_format]
        self.scale_hw = np.array([1.0, 1.0] if scale_hw is None else scale_hw)
        self.mode = ("raw" if dataset.__class__.__name__ == "KITTIRawDataset"
                     else "normal")

    # ------------------------------------------------------------------
    def get_labels(self, idx: int, search_key) -> List[np.ndarray]:
        """GT label arrays for image ``idx``, mask-filtered to valid rows.

        Parity: reference ``Visualizer.get_labels``
        (utils/visualizer.py:49-64)."""
        assert self.mode == "normal", (
            "This method is only available in 'normal' mode.")
        label = self.dataset[int(idx)]["label"]
        mask = np.asarray(label["mask"]).astype(bool)
        keys = [search_key] if isinstance(search_key, str) else search_key
        return [np.asarray(label[k])[mask] for k in keys]

    def _load_image(self, idx: int) -> np.ndarray:
        if self.mode == "normal":
            return self.dataset.load_image(idx)[0].copy()
        return np.ascontiguousarray(self.dataset[idx]["ori_img"][0])

    def _load_calib(self, idx: int):
        if self.mode == "normal":
            return self.dataset.load_calib(idx)
        return self.dataset[idx]["calib"][0]

    # ------------------------------------------------------------------
    def plot_bboxes_2d(self, idx: int, save_path: Optional[str] = None):
        image = self._load_image(idx)
        s = 1.0 / np.array([*self.scale_hw[::-1], *self.scale_hw[::-1]])
        for c_idx, boxes in enumerate(self.pred_bbox_2d[idx]):
            color = CLASS_IDX_TO_COLOR[c_idx]
            for box in np.asarray(boxes):
                with np.errstate(invalid="ignore"):
                    coords = (box[:4] * s).astype(np.int32)
                image = self._transparent_box(image, coords, color)
        return self._emit(image, save_path)

    def plot_bboxes_3d(self, idx: int, save_path: Optional[str] = None):
        image = self._load_image(idx)
        calib = self._load_calib(idx)
        boxes = np.asarray(self.pred_bbox_3d[idx]["boxes_3d"])
        labels = np.asarray(self.pred_bbox_3d[idx]["labels_3d"])
        if len(boxes) > 0:
            corners = boxes3d_to_corners(
                boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
            )                                             # (N, 8, 3)
            with np.errstate(all="ignore"):
                proj = project_to_image(corners, calib.P2)    # (N, 8, 2)
                s = 1.0 / self.scale_hw[::-1]
                proj = (np.round(proj - 1) * s).astype(np.int32)
            starts, ends = zip(*LINE_INDICES)
            for n in range(len(boxes)):
                # One box's 12 edges blended together, as 12 cv2.line
                # calls blend them (up to their successive rounding).
                draw.lines(image, proj[n, list(starts)], proj[n, list(ends)],
                           CLASS_IDX_TO_COLOR[int(labels[n])])
        return self._emit(image, save_path)

    def plot_bev(self, idx: int, save_path: Optional[str] = None):
        r = BEV_MAX_DIST * BEV_SCALE
        space = bev_grid().copy()
        boxes = np.asarray(self.pred_bbox_3d[idx]["boxes_3d"])
        labels = np.asarray(self.pred_bbox_3d[idx]["labels_3d"])
        if len(boxes) > 0:
            bev = boxes[:, [0, 2, 3, 5, 6]].copy()        # x, z, l, w, ry
            bev[:, :4] *= BEV_SCALE
            bev[:, 1] *= -1
            bev[:, :2] += r
            for n in range(len(bev)):
                with np.errstate(invalid="ignore"):
                    pts = draw.box_points(
                        (bev[n, 0], bev[n, 1]), (bev[n, 2], bev[n, 3]),
                        float(bev[n, 4] * 180 / np.pi)).astype(np.int32)
                color = CLASS_IDX_TO_COLOR[int(labels[n])]
                draw.fill_poly(space, pts, color)
        return self._emit(space, save_path)

    # ------------------------------------------------------------------
    def export_as_video(
        self,
        save_dir: str,
        plot_items: Sequence[str] = ("2d", "3d", "bev"),
        fps: int = 20,
    ) -> None:
        """Write every frame of each item to ``save_dir/<item>/NNNNNN.png``.
        ``EXPORT_WORKERS`` processes (spawned: the caller may hold a CUDA
        context) each draw and write one plot at a time; the drawing holds
        the interpreter lock, so threads would not overlap it. ``fps`` is
        not stored: PNG frames carry no rate (the rate to give an encoder,
        e.g. ``ffmpeg -framerate <fps> -i 2d/%06d.png``)."""
        assert self.mode == "raw", "video export needs a raw-sequence dataset"
        jobs = []
        for item in plot_items:
            item_dir = os.path.join(save_dir, item)
            os.makedirs(item_dir, exist_ok=True)
            jobs += [(_PLOTS[item], i, os.path.join(item_dir, f"{i:06d}.png"))
                     for i in range(len(self.dataset))]
        with ProcessPoolExecutor(
                EXPORT_WORKERS, mp_context=multiprocessing.get_context("spawn"),
                initializer=_adopt, initargs=(self,)) as pool:
            for _ in pool.map(_export_one, jobs, chunksize=4):
                pass

    # ------------------------------------------------------------------
    @staticmethod
    def _transparent_box(image, box, color, alpha: float = 0.2):
        """``addWeighted(filled, alpha, outlined, 1 - alpha, 0)`` of two
        copies of ``image``, one with the box filled, one with it outlined.
        Away from the box both copies are the image, which the weighted
        sum gives back unchanged, so only the box's pixels are worked."""
        x1, y1, x2, y2 = [int(v) for v in box]
        h, w = image.shape[:2]
        r = _OUTLINE_REACH
        top, bottom = max(min(y1, y2) - r, 0), min(max(y1, y2) + r, h - 1)
        left, right = max(min(x1, x2) - r, 0), min(max(x1, x2) + r, w - 1)
        if top > bottom or left > right:
            return image
        # The box in the window's coordinates: OpenCV clips to the image,
        # and the window holds the box's whole reach inside the image.
        window = image[top:bottom + 1, left:right + 1]
        p, q = (x1 - left, y1 - top), (x2 - left, y2 - top)
        outlined = draw.rectangle(window.copy(), p, q, color, 2)
        filled = draw.rectangle(window.copy(), p, q, color, -1)
        image[top:bottom + 1, left:right + 1] = draw.add_weighted(
            filled, alpha, outlined, 1 - alpha, 0)
        return image

    @staticmethod
    def _emit(image, save_path):
        if save_path is not None:
            write_png(save_path, np.ascontiguousarray(image, np.uint8))
            return None
        return image


_worker_visualizer: Optional[Visualizer] = None


def _adopt(visualizer: Visualizer) -> None:
    """An export process's initializer: the Visualizer it draws from."""
    global _worker_visualizer
    _worker_visualizer = visualizer


def _export_one(job) -> None:
    method, idx, path = job
    getattr(_worker_visualizer, method)(idx, save_path=path)
