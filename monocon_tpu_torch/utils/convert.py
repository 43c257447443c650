"""Host-side conversion of decoded detections to KITTI annotation dicts.

Parity: reference ``utils/kitti_convert_utils.py`` (convert_to_kitti_2d/3d,
get_valid_bboxes_3d) and the result packaging in
``monocon_heads._get_eval_formats`` (monocon_heads.py:333-376).

Device code hands over fixed-shape ``(B, K)`` arrays + scores; the
score-threshold filter and per-image ragged structures first appear here,
on the host, after the single device->host transfer.

A copy of ``monocon_tpu/utils/convert.py``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..data.calib import Calibration
from ..data.geometry import boxes3d_to_corners, expand_projection

CLASSES = ("Pedestrian", "Cyclist", "Car")

_EMPTY_ANNO = dict(
    name=np.array([]),
    truncated=np.array([]),
    occluded=np.array([]),
    alpha=np.array([]),
    bbox=np.zeros([0, 4]),
    dimensions=np.zeros([0, 3]),
    location=np.zeros([0, 3]),
    rotation_y=np.array([]),
    score=np.array([]),
)


def split_batch_detections(
    decoded: Dict[str, np.ndarray], score_threshold: float = 0.4
) -> List[Dict[str, np.ndarray]]:
    """(B, K) masked device outputs -> per-image ragged numpy detections.

    Mirrors the threshold filter at monocon_heads.py:467-482 (done there on
    device with ragged results; here it's the host boundary).
    """
    bboxes_2d = np.asarray(decoded["bboxes_2d"])
    bboxes_3d = np.asarray(decoded["bboxes_3d"])
    labels = np.asarray(decoded["labels"])
    results = []
    for b in range(bboxes_2d.shape[0]):
        keep = bboxes_2d[b, :, 4] > score_threshold
        results.append(
            {
                "bboxes_2d": bboxes_2d[b, keep],
                "bboxes_3d": bboxes_3d[b, keep],
                "labels": labels[b, keep],
                "scores": bboxes_2d[b, keep, 4],
            }
        )
    return results


def to_vis_format(per_image: List[Dict[str, np.ndarray]], num_classes: int = 3
                  ) -> List[Dict[str, Any]]:
    """Per-image detections -> the reference visualization format
    ({'img_bbox': {...}, 'img_bbox2d': [per-class (N,5)]})."""
    out = []
    for det in per_image:
        labels = det["labels"]
        by_class = [
            det["bboxes_2d"][labels == c] for c in range(num_classes)
        ]
        out.append(
            {
                "img_bbox": {
                    "boxes_3d": det["bboxes_3d"],
                    "scores_3d": det["scores"],
                    "labels_3d": labels,
                },
                "img_bbox2d": by_class,
            }
        )
    return out


def _scale_vector(img_metas: Dict[str, Any]) -> np.ndarray:
    """Reciprocal (w, h, w, h) rescale for Resize3D eval
    (kitti_convert_utils.py:103-108)."""
    scale_hw = img_metas.get("scale_hw")
    if scale_hw:
        sh, sw = scale_hw[0]
    else:
        sh = sw = 1.0
    return 1.0 / np.array([sw, sh, sw, sh], dtype=np.float64)


def convert_to_kitti_3d(
    per_image: List[Dict[str, np.ndarray]],
    img_metas: Dict[str, Any],
    calibs: Sequence[Calibration],
) -> List[Dict[str, np.ndarray]]:
    """3D detections -> KITTI annos (one dict per image).

    Parity: reference ``convert_to_kitti_3d`` + ``get_valid_bboxes_3d``
    (kitti_convert_utils.py:16-171). The corner math and projection run
    ONCE across all images of the batch (per-box gathered P2), so the
    host cost per eval batch is one vectorized pass instead of B small
    ones — same per-box arithmetic.
    """
    scale = _scale_vector(img_metas)
    nb = len(per_image)
    counts = np.array(
        [len(d["bboxes_3d"]) for d in per_image], dtype=np.int64
    )
    if counts.sum() > 0:
        boxes_all = np.concatenate(
            [np.asarray(d["bboxes_3d"], np.float64).reshape(-1, 7)
             for d in per_image]
        )
        img_idx = np.repeat(np.arange(nb), counts)
        corners = boxes3d_to_corners(
            boxes_all[:, :3], boxes_all[:, 3:6], boxes_all[:, 6]
        )  # (N, 8, 3)
        proj4 = np.stack([
            expand_projection(np.asarray(calibs[b].P2, np.float64))
            for b in range(nb)
        ])  # (nb, 4, 4)
        homo = np.concatenate(
            [corners, np.ones_like(corners[..., :1])], axis=-1
        )
        projected = np.einsum("nkj,nij->nki", homo, proj4[img_idx])
        uv = projected[..., :2] / projected[..., 2:3]
        bbox2d_all = np.concatenate([uv.min(axis=1), uv.max(axis=1)], -1)
    offs = np.concatenate([[0], np.cumsum(counts)])

    annos = []
    for b, det in enumerate(per_image):
        sample_idx = img_metas["sample_idx"][b]
        image_shape = img_metas["ori_shape"][b]  # (H, W)
        sl = slice(offs[b], offs[b + 1])
        boxes = boxes_all[sl] if counts[b] else np.zeros((0, 7))
        scores = np.asarray(det["scores"], dtype=np.float64)
        labels = np.asarray(det["labels"])

        if len(boxes) == 0:
            anno = {k: v.copy() for k, v in _EMPTY_ANNO.items()}
            anno["sample_idx"] = np.zeros([0], dtype=np.int64)
            annos.append(anno)
            continue

        bbox2d = bbox2d_all[sl]
        h, w = image_shape
        valid = (
            (bbox2d[:, 0] < w) & (bbox2d[:, 1] < h)
            & (bbox2d[:, 2] > 0) & (bbox2d[:, 3] > 0)
        )

        boxes, scores, labels, bbox2d = (
            boxes[valid], scores[valid], labels[valid], bbox2d[valid],
        )
        n = len(boxes)
        if n == 0:
            anno = {k: v.copy() for k, v in _EMPTY_ANNO.items()}
            anno["sample_idx"] = np.zeros([0], dtype=np.int64)
            annos.append(anno)
            continue

        bbox2d = bbox2d.copy()
        bbox2d[:, 2:] = np.minimum(bbox2d[:, 2:], [w, h])
        bbox2d[:, :2] = np.maximum(bbox2d[:, :2], [0, 0])

        anno = {
            "name": np.array([CLASSES[int(l)] for l in labels]),
            "truncated": np.zeros(n),
            "occluded": np.zeros(n, dtype=np.int64),
            "alpha": -np.arctan2(boxes[:, 0], boxes[:, 2]) + boxes[:, 6],
            "bbox": bbox2d * scale[None, :],
            "dimensions": boxes[:, 3:6],
            "location": boxes[:, :3],
            "rotation_y": boxes[:, 6],
            "score": scores,
            "sample_idx": np.full(n, sample_idx, dtype=np.int64),
        }
        annos.append(anno)
    return annos


def convert_to_kitti_2d(
    per_image: List[Dict[str, np.ndarray]],
    img_metas: Dict[str, Any],
    num_classes: int = 3,
) -> List[Dict[str, np.ndarray]]:
    """2D detections -> KITTI annos with dummy 3D fields (alpha=-10,
    loc=-1000). Parity: kitti_convert_utils.py:175-249."""
    scale = _scale_vector(img_metas)
    annos = []
    for b, det in enumerate(per_image):
        sample_idx = img_metas["sample_idx"][b]
        labels = det["labels"]
        boxes = np.asarray(det["bboxes_2d"], dtype=np.float64)
        n = len(boxes)
        if n == 0:
            anno = {k: v.copy() for k, v in _EMPTY_ANNO.items()}
            anno["sample_idx"] = np.zeros([0], dtype=np.int64)
            annos.append(anno)
            continue
        # class-major ordering, as the reference emits per-class blocks.
        order = np.argsort(labels, kind="stable")
        labels_o, boxes_o = labels[order], boxes[order]
        anno = {
            "name": np.array([CLASSES[int(l)] for l in labels_o]),
            "truncated": np.zeros(n),
            "occluded": np.zeros(n, dtype=np.int64),
            "alpha": np.full(n, -10.0),
            "bbox": boxes_o[:, :4] * scale[None, :],
            "dimensions": np.zeros((n, 3)),
            "location": np.full((n, 3), -1000.0),
            "rotation_y": np.zeros(n),
            "score": boxes_o[:, 4],
            "sample_idx": np.full(n, sample_idx, dtype=np.int64),
        }
        annos.append(anno)
    return annos
