"""Top-level KITTI evaluation: AP40 tables at two overlap regimes + flat
metric dict, and the coco-style variant.

Parity: reference ``kitti_eval`` (eval.py:666-812) and
``kitti_eval_coco_style`` (eval.py:815-884): same overlap matrices, same
AOS auto-enable when predicted alphas are valid, same result-key scheme
``KITTI/{cls}_{metric}_AP40_{difficulty}_{strict|loose}``.

A copy of ``monocon_tpu/eval/kitti_eval.py``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .protocol import eval_class, get_map11, get_map40

CLASS_TO_NAME = {0: "Car", 1: "Pedestrian", 2: "Cyclist", 3: "Van",
                 4: "Person_sitting"}
NAME_TO_CLASS = {v: k for k, v in CLASS_TO_NAME.items()}

# min_overlaps[regime, metric(bbox,bev,3d,aos-bbox,unused), class]
# (eval.py:688-694).
_OVERLAP_STRICT = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5],
                            [0.7, 0.5, 0.5, 0.7, 0.5]])
_OVERLAP_LOOSE = np.array([[0.7, 0.5, 0.5, 0.7, 0.5],
                           [0.5, 0.25, 0.25, 0.5, 0.25],
                           [0.5, 0.25, 0.25, 0.5, 0.25]])


def _resolve_classes(current_classes) -> List[int]:
    if not isinstance(current_classes, (list, tuple)):
        current_classes = [current_classes]
    return [
        NAME_TO_CLASS[c] if isinstance(c, str) else int(c)
        for c in current_classes
    ]


def do_eval(
    gt_annos: List[Dict],
    dt_annos: List[Dict],
    current_classes: Sequence[int],
    min_overlaps: np.ndarray,
    eval_types: Sequence[str] = ("bbox", "bev", "3d"),
):
    """(mAP11, mAP40) x (bbox, bev, 3d, aos) — eval.py:600-643."""
    from .protocol import _flat_clean_caches

    difficultys = [0, 1, 2]
    out = {"bbox": (None, None), "bev": (None, None), "3d": (None, None),
           "aos": (None, None)}
    # The flat clean-data inputs (and their per-(class,difficulty) ignore
    # memo) are metric-invariant: build once and share across the
    # bbox/bev/3d eval_class calls.
    caches = _flat_clean_caches(gt_annos, dt_annos)
    if "bbox" in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 0,
                         min_overlaps, compute_aos="aos" in eval_types,
                         caches=caches)
        out["bbox"] = (get_map11(ret["precision"]), get_map40(ret["precision"]))
        if "aos" in eval_types:
            out["aos"] = (get_map11(ret["orientation"]),
                          get_map40(ret["orientation"]))
    if "bev" in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 1,
                         min_overlaps, caches=caches)
        out["bev"] = (get_map11(ret["precision"]), get_map40(ret["precision"]))
    if "3d" in eval_types:
        ret = eval_class(gt_annos, dt_annos, current_classes, difficultys, 2,
                         min_overlaps, caches=caches)
        out["3d"] = (get_map11(ret["precision"]), get_map40(ret["precision"]))
    return out


def kitti_eval(
    gt_annos: List[Dict],
    dt_annos: List[Dict],
    current_classes,
    eval_types: Sequence[str] = ("bbox", "bev", "3d"),
) -> Tuple[str, Dict[str, float]]:
    eval_types = list(eval_types)
    assert eval_types, "must contain at least one evaluation type"
    if "aos" in eval_types:
        assert "bbox" in eval_types, "AOS requires bbox evaluation"

    classes = _resolve_classes(current_classes)
    min_overlaps = np.stack([_OVERLAP_STRICT, _OVERLAP_LOOSE])[:, :, classes]

    # AOS auto-enable when both GT and predicted alphas are valid
    # (eval.py:714-729).
    pred_alpha = any(
        (a["alpha"][a["alpha"] != -10].shape[0] != 0) for a in dt_annos
    )
    valid_alpha_gt = any(
        len(a["alpha"]) > 0 and a["alpha"][0] != -10 for a in gt_annos
    )
    compute_aos = pred_alpha and valid_alpha_gt
    if compute_aos and "aos" not in eval_types:
        eval_types.append("aos")

    results = do_eval(gt_annos, dt_annos, classes, min_overlaps, eval_types)
    _, map40_bbox = results["bbox"]
    _, map40_bev = results["bev"]
    _, map40_3d = results["3d"]
    _, map40_aos = results["aos"]

    ret: Dict[str, float] = {}
    difficulty = ["easy", "moderate", "hard"]
    lines = ["", "----------- Eval Results ------------"]
    for j, cls in enumerate(classes):
        name = CLASS_TO_NAME[cls]
        for i in range(min_overlaps.shape[0]):
            lines.append(
                "{} AP40@{:.2f}, {:.2f}, {:.2f}:".format(
                    name, *min_overlaps[i, :3, j])
            )
            if map40_bbox is not None:
                lines.append("bbox AP40:{:.4f}, {:.4f}, {:.4f}".format(
                    *map40_bbox[j, :, i]))
            if map40_bev is not None:
                lines.append("bev  AP40:{:.4f}, {:.4f}, {:.4f}".format(
                    *map40_bev[j, :, i]))
            if map40_3d is not None:
                lines.append("3d   AP40:{:.4f}, {:.4f}, {:.4f}".format(
                    *map40_3d[j, :, i]))
            if compute_aos and map40_aos is not None:
                lines.append("aos  AP40:{:.2f}, {:.2f}, {:.2f}".format(
                    *map40_aos[j, :, i]))
            postfix_tag = "strict" if i == 0 else "loose"
            for idx in range(3):
                postfix = f"{difficulty[idx]}_{postfix_tag}"
                prefix = f"KITTI/{name}"
                if map40_3d is not None:
                    ret[f"{prefix}_3D_AP40_{postfix}"] = float(map40_3d[j, idx, i])
                if map40_bev is not None:
                    ret[f"{prefix}_BEV_AP40_{postfix}"] = float(map40_bev[j, idx, i])
                if map40_bbox is not None:
                    ret[f"{prefix}_2D_AP40_{postfix}"] = float(map40_bbox[j, idx, i])

    if len(classes) > 1:
        lines.append("")
        lines.append("Overall AP40@{}, {}, {}:".format(*difficulty))
        if map40_bbox is not None:
            mean_bbox = map40_bbox.mean(axis=0)
            lines.append("bbox AP40:{:.4f}, {:.4f}, {:.4f}".format(*mean_bbox[:, 0]))
        if map40_bev is not None:
            mean_bev = map40_bev.mean(axis=0)
            lines.append("bev  AP40:{:.4f}, {:.4f}, {:.4f}".format(*mean_bev[:, 0]))
        if map40_3d is not None:
            mean_3d = map40_3d.mean(axis=0)
            lines.append("3d   AP40:{:.4f}, {:.4f}, {:.4f}".format(*mean_3d[:, 0]))
        if compute_aos and map40_aos is not None:
            mean_aos = map40_aos.mean(axis=0)
            lines.append("aos  AP40:{:.2f}, {:.2f}, {:.2f}".format(*mean_aos[:, 0]))
        for idx in range(3):
            if map40_3d is not None:
                ret[f"KITTI/Overall_3D_AP40_{difficulty[idx]}"] = float(mean_3d[idx, 0])
            if map40_bev is not None:
                ret[f"KITTI/Overall_BEV_AP40_{difficulty[idx]}"] = float(mean_bev[idx, 0])
            if map40_bbox is not None:
                ret[f"KITTI/Overall_2D_AP40_{difficulty[idx]}"] = float(mean_bbox[idx, 0])
    lines.append("-------------------------------------")
    return "\n".join(lines), ret


def kitti_eval_coco_style(
    gt_annos: List[Dict], dt_annos: List[Dict], current_classes
) -> str:
    """coco-style AP over overlap range 0.5:0.05:0.95 (cars) /
    0.25:0.05:0.7 (ped/cyc) — eval.py:646-663, 815-884."""
    class_to_range = {
        0: [0.5, 0.95, 10], 1: [0.25, 0.7, 10], 2: [0.25, 0.7, 10],
        3: [0.5, 0.95, 10], 4: [0.25, 0.7, 10],
    }
    classes = _resolve_classes(current_classes)
    overlap_ranges = np.zeros([3, 3, len(classes)])
    for i, cls in enumerate(classes):
        overlap_ranges[:, :, i] = np.array(class_to_range[cls])[:, None]

    compute_aos = False
    for a in dt_annos:
        if a["alpha"].shape[0] != 0:
            compute_aos = a["alpha"][0] != -10
            break

    min_overlaps = np.zeros([10, *overlap_ranges.shape[1:]])
    for i in range(overlap_ranges.shape[1]):
        for j in range(overlap_ranges.shape[2]):
            lo, hi, n = overlap_ranges[:, i, j]
            min_overlaps[:, i, j] = np.linspace(lo, hi, int(n))

    types = ["bbox", "bev", "3d"] + (["aos"] if compute_aos else [])
    results = do_eval(gt_annos, dt_annos, classes, min_overlaps, types)
    map_bbox = results["bbox"][0].mean(-1)
    map_bev = results["bev"][0].mean(-1)
    map_3d = results["3d"][0].mean(-1)
    map_aos = results["aos"][0].mean(-1) if compute_aos else None

    lines = []
    for j, cls in enumerate(classes):
        rng = np.array(class_to_range[cls])[[0, 2, 1]]
        rng[1] = (rng[2] - rng[0]) / (rng[1] - 1)
        lines.append(
            f"{CLASS_TO_NAME[cls]} coco "
            "AP@{:.2f}:{:.2f}:{:.2f}:".format(*rng)
        )
        lines.append("bbox AP:{:.2f}, {:.2f}, {:.2f}".format(*map_bbox[j]))
        lines.append("bev  AP:{:.2f}, {:.2f}, {:.2f}".format(*map_bev[j]))
        lines.append("3d   AP:{:.2f}, {:.2f}, {:.2f}".format(*map_3d[j]))
        if compute_aos:
            lines.append("aos  AP:{:.2f}, {:.2f}, {:.2f}".format(*map_aos[j]))
    return "\n".join(lines)
