"""Official KITTI AP evaluation protocol (AP40/AP11, bbox/BEV/3D/AOS).

Behavioral parity with the reference ``engine/kitti_eval/eval.py`` — the
41-recall-point threshold selection, per-difficulty ignore rules, greedy
TP/FP matching with DontCare suppression, precision right-envelope, and the
two overlap regimes — implemented in numpy, with the greedy matcher and
the rotated overlap in C++ (``native.py``, the numba replacement,
SURVEY.md §2.9).

Annotation dicts: {'name','truncated','occluded','alpha','bbox',
'dimensions','location','rotation_y','score'} per image.

A copy of ``monocon_tpu/eval/protocol.py`` without its references: the
pure-Python matcher, the per-image overlap matrices and the per-image
ignore rules. The port's tests hold this module against the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .rotate_iou import rotate_iou_pairs

CLASS_NAMES = ("Car", "Pedestrian", "Cyclist", "Van", "Person_sitting")
N_SAMPLE_PTS = 41

# Per-difficulty ignore rules (eval.py:36-39).
MIN_HEIGHT = (40, 25, 25)
MAX_OCCLUSION = (0, 1, 2)
MAX_TRUNCATION = (0.15, 0.3, 0.5)


def select_thresholds(scores: np.ndarray, num_gt: int,
                      num_sample_pts: int = N_SAMPLE_PTS) -> np.ndarray:
    """Pick score thresholds hitting ~41 evenly spaced recall points
    (eval.py:14-32)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return np.array(thresholds)


def _flat_clean_caches(gt_annos: List[Dict], dt_annos: List[Dict]) -> Dict:
    """Concatenated clean-data inputs over ALL images, plus offsets.

    The ignore-code assignment (eval.py:35-87) is elementwise over
    objects, so one vectorized pass over the flattened object arrays
    per (class, difficulty) replaces ``num_images`` Python calls (3769
    images x 27 (metric, cls, diff) combinations at val scale). Results
    are memoized per
    (class, difficulty) in ``memo`` — they are metric-invariant, so
    do_eval's three eval_class calls share them.
    """
    def cat(parts, dtype=None):
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype or np.float64))

    names_gt = cat([np.asarray(a["name"], dtype=np.str_)
                    for a in gt_annos], np.str_)
    return {
        "gt_off": np.concatenate(
            [[0], np.cumsum([len(a["name"]) for a in gt_annos])]
        ).astype(np.int64),
        "dt_off": np.concatenate(
            [[0], np.cumsum([len(a["name"]) for a in dt_annos])]
        ).astype(np.int64),
        "names_gt": np.char.lower(names_gt),
        "heights_gt": cat([a["bbox"][:, 3] - a["bbox"][:, 1]
                           for a in gt_annos]),
        "occluded": cat([np.asarray(a["occluded"]) for a in gt_annos],
                        np.int64),
        "truncated": cat([np.asarray(a["truncated"]) for a in gt_annos]),
        "dc": [a["bbox"][np.asarray(a["name"]) == "DontCare"]
               .astype(np.float64).reshape(-1, 4) for a in gt_annos],
        "names_dt": np.char.lower(cat([np.asarray(a["name"], dtype=np.str_)
                                       for a in dt_annos], np.str_)),
        "heights_dt": cat([np.abs(a["bbox"][:, 3] - a["bbox"][:, 1])
                           for a in dt_annos]),
        "memo": {},
    }


def _clean_all_from_flat(flat: Dict, current_class: int, difficulty: int):
    """The reference's ``clean_data`` (eval.py:35-87) vectorized over all
    images: identical ignore semantics, computed on the concatenated
    object arrays. Returns (total_valid_gt, ignored_gt_flat, ignored_dt_flat);
    per-image arrays are offset slices of the flats. Memoized per
    (class, difficulty); callers must treat the arrays as read-only."""
    key = (current_class, difficulty)
    if key in flat["memo"]:
        return flat["memo"][key]
    cls_name = CLASS_NAMES[current_class].lower()
    names_gt = flat["names_gt"]

    valid = np.where(names_gt == cls_name, 1, -1)
    if cls_name == "pedestrian":
        valid = np.where(names_gt == "person_sitting", 0, valid)
    elif cls_name == "car":
        valid = np.where(names_gt == "van", 0, valid)
    too_hard = (
        (flat["occluded"] > MAX_OCCLUSION[difficulty])
        | (flat["truncated"] > MAX_TRUNCATION[difficulty])
        | (flat["heights_gt"] <= MIN_HEIGHT[difficulty])
    )
    counted = (valid == 1) & ~too_hard
    ignored_gt = np.full(len(names_gt), -1, dtype=np.int64)
    ignored_gt[counted] = 0
    ignored_gt[(valid == 0) | ((valid == 1) & too_hard)] = 1
    total_valid = int(counted.sum())

    ignored_dt = np.where(
        flat["heights_dt"] < MIN_HEIGHT[difficulty], np.int64(1),
        np.where(flat["names_dt"] == cls_name, np.int64(0), np.int64(-1)),
    )
    flat["memo"][key] = (total_valid, ignored_gt, ignored_dt)
    return flat["memo"][key]


def image_box_overlap(boxes: np.ndarray, qboxes: np.ndarray,
                      criterion: int = -1) -> np.ndarray:
    """Vectorized axis-aligned IoU matrix (eval.py:90-119)."""
    n, k = boxes.shape[0], qboxes.shape[0]
    if n == 0 or k == 0:
        return np.zeros((n, k))
    iw = (np.minimum(boxes[:, None, 2], qboxes[None, :, 2])
          - np.maximum(boxes[:, None, 0], qboxes[None, :, 0]))
    ih = (np.minimum(boxes[:, None, 3], qboxes[None, :, 3])
          - np.maximum(boxes[:, None, 1], qboxes[None, :, 1]))
    inter = np.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    area1 = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))[:, None]
    area2 = ((qboxes[:, 2] - qboxes[:, 0]) * (qboxes[:, 3] - qboxes[:, 1]))[None]
    if criterion == -1:
        denom = area1 + area2 - inter
    elif criterion == 0:
        denom = np.broadcast_to(area1, inter.shape)
    elif criterion == 1:
        denom = np.broadcast_to(area2, inter.shape)
    else:
        denom = np.ones_like(inter)
    return np.where(inter > 0, inter / denom, 0.0)


def bev_boxes(anno: Dict) -> np.ndarray:
    return np.concatenate(
        [anno["location"][:, [0, 2]], anno["dimensions"][:, [0, 2]],
         anno["rotation_y"][:, None]], axis=1,
    )


def camera_boxes(anno: Dict) -> np.ndarray:
    return np.concatenate(
        [anno["location"], anno["dimensions"], anno["rotation_y"][:, None]],
        axis=1,
    )


# Flat-pair chunk size for the batched rotated-IoU sweep: bounds the
# float64 copies handed to the kernel per call.
_PAIR_CHUNK = 262_144


def compute_overlaps_all(gt_annos: List[Dict], dt_annos: List[Dict],
                         metric: int) -> List[np.ndarray]:
    """Every image's (num_dt, num_gt) overlap matrix in ONE batched
    rotated-IoU sweep.

    Identical results to one overlap matrix per image — the clip kernel
    runs over pairs, so flattening all images' pair grids removes the 3769-iteration Python loop that
    dominated val-scale eval wall time (~9.6 s of 18.5 s; the reference
    instead launches one numba.cuda kernel per image,
    eval.py:128-133/347-422). Metric 0's axis-aligned IoU stays
    per-image (vectorized and cheap).
    """
    n_img = len(gt_annos)
    if metric == 0:
        return [image_box_overlap(dt_annos[i]["bbox"], gt_annos[i]["bbox"])
                for i in range(n_img)]
    to_boxes = bev_boxes if metric == 1 else camera_boxes
    dts = [to_boxes(d) for d in dt_annos]
    gts = [to_boxes(g) for g in gt_annos]

    # Flatten every image's (num_dt x num_gt) pair grid, row-major.
    d_flat = np.concatenate(
        [np.repeat(d, g.shape[0], axis=0) for d, g in zip(dts, gts)]
        or [np.zeros((0, dts[0].shape[1] if dts else 5))])
    g_flat = np.concatenate(
        [np.tile(g, (d.shape[0], 1)) for d, g in zip(dts, gts)]
        or [np.zeros_like(d_flat)])

    chunks = []
    for lo in range(0, len(d_flat), _PAIR_CHUNK):
        d_c = d_flat[lo:lo + _PAIR_CHUNK]
        g_c = g_flat[lo:lo + _PAIR_CHUNK]
        if metric == 1:
            chunks.append(rotate_iou_pairs(d_c, g_c).astype(np.float64))
        else:
            chunks.append(_d3_overlap_pairs(d_c, g_c))
    flat = (np.concatenate(chunks) if chunks
            else np.zeros(0, dtype=np.float64))

    out, pos = [], 0
    for d, g in zip(dts, gts):
        cnt = d.shape[0] * g.shape[0]
        out.append(flat[pos:pos + cnt].reshape(d.shape[0], g.shape[0]))
        pos += cnt
    return out


def _d3_overlap_pairs(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """Pairwise (aligned) 3D overlap at criterion -1: rotated BEV
    intersection x vertical overlap (eval.py:128-164). Camera boxes
    (x,y,z,l,h,w,ry); y points down, y is the box bottom."""
    rinc = rotate_iou_pairs(
        boxes[:, [0, 2, 3, 5, 6]], qboxes[:, [0, 2, 3, 5, 6]], 2
    ).astype(np.float64)
    iw = (np.minimum(boxes[:, 1], qboxes[:, 1])
          - np.maximum(boxes[:, 1] - boxes[:, 4],
                       qboxes[:, 1] - qboxes[:, 4]))
    vol1 = boxes[:, 3] * boxes[:, 4] * boxes[:, 5]
    vol2 = qboxes[:, 3] * qboxes[:, 4] * qboxes[:, 5]
    inc = np.where(iw > 0, iw * rinc, 0.0)
    denom = vol1 + vol2 - inc
    return np.where((rinc > 0) & (iw > 0), inc / denom, 0.0)


def eval_class(
    gt_annos: List[Dict],
    dt_annos: List[Dict],
    current_classes: Sequence[int],
    difficultys: Sequence[int],
    metric: int,
    min_overlaps: np.ndarray,   # (num_overlap, metric, class)
    compute_aos: bool = False,
    caches: Optional[Dict] = None,
) -> Dict[str, np.ndarray]:
    """PR curves per (class, difficulty, overlap) — eval.py:456-574.

    ``caches``: optional precomputed :func:`_flat_clean_caches` structure —
    it is metric-invariant (including its per-(class,difficulty) memo), so
    :func:`kitti_eval.do_eval` builds it once and shares it across the
    bbox/bev/3d calls instead of paying it 3x at val scale."""
    from .native import FlatPack, batch_match, batch_match_scores

    assert len(gt_annos) == len(dt_annos)
    num_images = len(gt_annos)
    overlaps = compute_overlaps_all(gt_annos, dt_annos, metric)

    shape = (len(current_classes), len(difficultys),
             min_overlaps.shape[0], N_SAMPLE_PTS)
    precision = np.zeros(shape)
    recall = np.zeros(shape)
    aos = np.zeros(shape)

    # Everything except the ignore codes is class/difficulty-invariant:
    # build the flat clean inputs, f64 views, and the flattened C++ pack
    # once, not per (class, difficulty, regime) — at val scale the
    # re-flattening otherwise dominates the evaluator's host time.
    if caches is None:
        caches = _flat_clean_caches(gt_annos, dt_annos)
    image_args = [
        dict(
            overlaps=overlaps[i],
            gt_alphas=gt_annos[i]["alpha"].astype(np.float64),
            dt_alphas=dt_annos[i]["alpha"].astype(np.float64),
            dt_scores=dt_annos[i]["score"].astype(np.float64),
            dt_bboxes=dt_annos[i]["bbox"].astype(np.float64),
            dc_bboxes=caches["dc"][i],
        )
        for i in range(num_images)
    ]
    pack = FlatPack(image_args)

    for m, cls in enumerate(current_classes):
        for d, difficulty in enumerate(difficultys):
            total_valid_gt, ig_gt_flat, ig_dt_flat = _clean_all_from_flat(
                caches, cls, difficulty
            )
            pack.set_ignored_flat(ig_gt_flat, ig_dt_flat)
            for k in range(min_overlaps.shape[0]):
                min_overlap = float(min_overlaps[k, metric, m])
                if total_valid_gt == 0:
                    continue
                # Matched-TP scores at thresh=0 (eval.py:128-133).
                all_scores = batch_match_scores(pack, metric, min_overlap)
                thresholds = select_thresholds(all_scores, total_valid_gt)
                if len(thresholds) == 0:
                    continue
                pr = batch_match(
                    pack, metric, min_overlap, thresholds, compute_aos
                )  # (T, 4): tp, fp, fn, similarity
                t = len(thresholds)
                recall[m, d, k, :t] = pr[:, 0] / (pr[:, 0] + pr[:, 2])
                precision[m, d, k, :t] = pr[:, 0] / (pr[:, 0] + pr[:, 1])
                if compute_aos:
                    aos[m, d, k, :t] = pr[:, 3] / (pr[:, 0] + pr[:, 1])
                # Right-envelope (max over the tail) — eval.py:555-562.
                for i in range(t):
                    precision[m, d, k, i] = np.max(precision[m, d, k, i:])
                    recall[m, d, k, i] = np.max(recall[m, d, k, i:])
                    if compute_aos:
                        aos[m, d, k, i] = np.max(aos[m, d, k, i:])
    return {"recall": recall, "precision": precision, "orientation": aos}


def get_map11(prec: np.ndarray) -> np.ndarray:
    return sum(prec[..., i] for i in range(0, prec.shape[-1], 4)) / 11 * 100


def get_map40(prec: np.ndarray) -> np.ndarray:
    return sum(prec[..., i] for i in range(1, prec.shape[-1])) / 40 * 100
