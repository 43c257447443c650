"""The KITTI evaluator's wall time at the val split's scale.

    python -m monocon_tpu_torch.checks.eval_scale [--images 3769] [--seed 0]
        [--json out.json] [--profile] [--train-ms-per-step MS]

Port of the JAX package's ``scripts/eval_scale_bench.py``. It makes
``images`` images' worth of synthetic annotations at KITTI's detection
density (3769 is the val split's size) and times the port's
``kitti_eval`` end to end with the C++ matcher (``end_to_end_cpp_s``),
then, with ``--profile``, the cProfile top 40 of a second end-to-end run
(``profile_top``), then the stages of ``eval_class`` for metric 2 (3D),
every class and difficulty, both overlap regimes (``stages_3d``). Each
stage's time is the least of ``STAGE_REPEATS`` repeats (the record's
``stage_repeats``): the host's noise moves single runs by large factors.

The stages are the port's ``eval_class``'s. Where a stage has a
counterpart in the JAX package, it keeps the JAX name:

- ``overlap_matrices_3d``: ``compute_overlaps_all`` (metric 2);
- ``clean_data_flat_vectorized``: ``_flat_clean_caches`` and the nine
  ``_clean_all_from_flat`` calls;
- ``threshold_matching``: ``batch_match_scores`` and ``select_thresholds``;
- ``fused_pr``: ``batch_match``;

and the port's own stages take new names:

- ``flat_pack``: the per-image arguments, the ``FlatPack`` build and its
  nine ``set_ignored_flat`` calls;
- ``right_envelope``: recall and precision from the PR tables and the
  loop that takes their right envelope.

Left out of the JAX record: ``overlap_3d_per_image_vs_batched_400img``
and ``clean_data_uncached_9x`` time the JAX package's per-image
``compute_overlap`` and ``clean_data``, which the port does not have (its
evaluator runs the batched forms alone); ``subset_images``,
``subset_cpp_s``, ``subset_python_s`` and ``python_extrapolated_s`` time
the JAX package's pure-Python matcher, and the port's matcher has no
fallback by design (``eval/native.py``).

Added to it: ``seed``; ``device``, the host's CPU and, where there is a
card, its name and power limit (``checks.device_label``); ``ap_keys``;
``ap_equals_jax``, whether the AP dict equals, key for key and float for
float, the JAX package's on the same annotations
(``resources/eval_scale_jax_ap.json``, for the images and seed it was made
at; else null); and with ``--train-ms-per-step``, ``eval_period``: the
end-to-end time's share of one ``EVAL_PERIOD`` of the shipped config
(``configs/kitti_v5e.yaml``: an evaluation every 10 epochs of 3712 images
at batch 16, 232 steps an epoch), the period being those steps at the
given ms/step plus the evaluation.

The run is the host's alone: the evaluator is numpy and host C++ and
needs no CUDA. So this entry point takes no ``--device`` and does not
call ``resolve_device``; running on the CPU is not a fallback here. The
exit code is 1 when the AP dict differs from the JAX package's.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import platform
import pstats
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..eval import kitti_eval
from ..eval import protocol
from ..eval.kitti_eval import _OVERLAP_LOOSE, _OVERLAP_STRICT
from ..eval.native import FlatPack, batch_match, batch_match_scores, get_lib
from . import device_label

CLASSES = ["Car", "Pedestrian", "Cyclist"]
CLASS_FREQ = (  # objects/image, eyeballed from KITTI class statistics
    ("Car", 4.0), ("Pedestrian", 0.6), ("Cyclist", 0.2),
    ("Van", 0.8), ("Person_sitting", 0.06), ("DontCare", 1.5),
)
DIMS = {  # (l, h, w) means
    "Car": (3.9, 1.6, 1.6), "Van": (5.1, 2.2, 1.9),
    "Pedestrian": (0.8, 1.8, 0.6), "Person_sitting": (0.8, 1.3, 0.6),
    "Cyclist": (1.8, 1.7, 0.6), "DontCare": (-1.0, -1.0, -1.0),
}
STAGE_REPEATS = 3
PROFILE_TOP = 40
# configs/kitti_v5e.yaml: PERIOD.EVAL_PERIOD, DATA.BATCH_SIZE; KITTI's
# train split.
EVAL_PERIOD_EPOCHS = 10
TRAIN_IMAGES = 3712
TRAIN_BATCH = 16
JAX_AP = Path(__file__).resolve().parent / "resources" / "eval_scale_jax_ap.json"


def synth_annos(num_images: int, seed: int = 0
                ) -> Tuple[List[Dict], List[Dict]]:
    """GT and DT annotation lists at KITTI-like density, the JAX script's
    draws in its order: DT boxes are jittered copies of most GT boxes plus
    false positives, so that the PR curves and the matcher's work look
    like a real evaluation's."""
    rng = np.random.default_rng(seed)
    gt_annos, dt_annos = [], []
    for _ in range(num_images):
        names, trunc, occ, alpha, bbox, dims, loc, rot = (
            [], [], [], [], [], [], [], [])
        for cls, freq in CLASS_FREQ:
            for _ in range(rng.poisson(freq)):
                names.append(cls)
                trunc.append(float(rng.uniform(0, 0.6)))
                occ.append(int(rng.integers(0, 4)))
                alpha.append(float(rng.uniform(-np.pi, np.pi)))
                x1 = rng.uniform(0, 1100)
                y1 = rng.uniform(120, 340)
                w = rng.uniform(25, 260)
                h = rng.uniform(18, 130)
                bbox.append([x1, y1, x1 + w, y1 + h])
                dims.append(np.abs(rng.normal(DIMS[cls], 0.15)))
                loc.append([rng.uniform(-25, 25), rng.uniform(0.5, 2.5),
                            rng.uniform(3, 70)])
                rot.append(float(rng.uniform(-np.pi, np.pi)))
        n = len(names)
        gt = {
            "name": np.array(names),
            "truncated": np.array(trunc, np.float64),
            "occluded": np.array(occ, np.int64),
            "alpha": np.array(alpha, np.float64),
            "bbox": np.array(bbox, np.float64).reshape(n, 4),
            "dimensions": np.array(dims, np.float64).reshape(n, 3),
            "location": np.array(loc, np.float64).reshape(n, 3),
            "rotation_y": np.array(rot, np.float64),
            "score": np.zeros(n, np.float64),
        }
        gt_annos.append(gt)

        # detections: ~80% of gts redetected with jitter + Poisson(6) FPs
        keep = rng.random(n) < 0.8
        idx = np.flatnonzero(keep & (gt["name"] != "DontCare"))
        n_fp = rng.poisson(6)
        d_names = list(gt["name"][idx])
        d_bbox = gt["bbox"][idx] + rng.normal(0, 6, (len(idx), 4))
        d_dims = gt["dimensions"][idx] * rng.uniform(0.85, 1.15,
                                                     (len(idx), 3))
        d_loc = gt["location"][idx] + rng.normal(0, 0.8, (len(idx), 3))
        d_rot = gt["rotation_y"][idx] + rng.normal(0, 0.25, len(idx))
        d_alpha = gt["alpha"][idx] + rng.normal(0, 0.25, len(idx))
        d_score = rng.uniform(0.3, 1.0, len(idx))
        for _ in range(n_fp):
            cls = ("Car", "Pedestrian", "Cyclist")[int(rng.integers(0, 3))]
            d_names.append(cls)
            x1, y1 = rng.uniform(0, 1100), rng.uniform(120, 340)
            d_bbox = np.vstack([d_bbox,
                                [x1, y1, x1 + rng.uniform(25, 260),
                                 y1 + rng.uniform(18, 130)]])
            d_dims = np.vstack([d_dims, np.abs(rng.normal(DIMS[cls], 0.2))])
            d_loc = np.vstack([d_loc, [rng.uniform(-25, 25),
                                       rng.uniform(0.5, 2.5),
                                       rng.uniform(3, 70)]])
            d_rot = np.append(d_rot, rng.uniform(-np.pi, np.pi))
            d_alpha = np.append(d_alpha, rng.uniform(-np.pi, np.pi))
            d_score = np.append(d_score, rng.uniform(0.05, 0.6))
        m = len(d_names)
        dt_annos.append({
            "name": np.array(d_names),
            "truncated": np.zeros(m, np.float64),
            "occluded": np.zeros(m, np.int64),
            "alpha": np.array(d_alpha, np.float64),
            "bbox": np.asarray(d_bbox, np.float64).reshape(m, 4),
            "dimensions": np.asarray(d_dims, np.float64).reshape(m, 3),
            "location": np.asarray(d_loc, np.float64).reshape(m, 3),
            "rotation_y": np.array(d_rot, np.float64),
            "score": np.array(d_score, np.float64),
        })
    return gt_annos, dt_annos


def _stages_once(gt_annos: List[Dict], dt_annos: List[Dict],
                 classes=(0, 1, 2)) -> Dict[str, float]:
    """One timed pass of ``protocol.eval_class``'s work for metric 2, stage
    by stage (see the module docstring)."""
    metric = 2
    min_overlaps = np.stack([_OVERLAP_STRICT, _OVERLAP_LOOSE])[
        :, :, list(classes)]
    clock = time.perf_counter
    out = {}

    t0 = clock()
    overlaps = protocol.compute_overlaps_all(gt_annos, dt_annos, metric)
    out["overlap_matrices_3d"] = clock() - t0

    t0 = clock()
    caches = protocol._flat_clean_caches(gt_annos, dt_annos)
    cleaned = {(m, d): protocol._clean_all_from_flat(caches, cls, d)
               for m, cls in enumerate(classes) for d in range(3)}
    out["clean_data_flat_vectorized"] = clock() - t0

    t0 = clock()
    pack = FlatPack([
        dict(overlaps=overlaps[i],
             gt_alphas=gt_annos[i]["alpha"].astype(np.float64),
             dt_alphas=dt_annos[i]["alpha"].astype(np.float64),
             dt_scores=dt_annos[i]["score"].astype(np.float64),
             dt_bboxes=dt_annos[i]["bbox"].astype(np.float64),
             dc_bboxes=caches["dc"][i])
        for i in range(len(gt_annos))])
    t_pack = clock() - t0

    t_thresh = t_pr = t_envelope = 0.0
    for m in range(len(classes)):
        for d in range(3):
            total_valid_gt, ig_gt, ig_dt = cleaned[(m, d)]
            t0 = clock()
            pack.set_ignored_flat(ig_gt, ig_dt)
            t_pack += clock() - t0
            for k in range(min_overlaps.shape[0]):
                min_overlap = float(min_overlaps[k, metric, m])
                if total_valid_gt == 0:
                    continue
                t0 = clock()
                scores = batch_match_scores(pack, metric, min_overlap)
                thresholds = protocol.select_thresholds(scores,
                                                        total_valid_gt)
                t_thresh += clock() - t0
                if len(thresholds) == 0:
                    continue
                t0 = clock()
                pr = batch_match(pack, metric, min_overlap, thresholds,
                                 False)
                t_pr += clock() - t0
                t0 = clock()
                t = len(thresholds)
                precision = np.zeros(protocol.N_SAMPLE_PTS)
                recall = np.zeros(protocol.N_SAMPLE_PTS)
                recall[:t] = pr[:, 0] / (pr[:, 0] + pr[:, 2])
                precision[:t] = pr[:, 0] / (pr[:, 0] + pr[:, 1])
                for i in range(t):
                    precision[i] = np.max(precision[i:])
                    recall[i] = np.max(recall[i:])
                t_envelope += clock() - t0
    out["flat_pack"] = t_pack
    out["threshold_matching"] = t_thresh
    out["fused_pr"] = t_pr
    out["right_envelope"] = t_envelope
    return out


def stage_attribution(gt_annos: List[Dict],
                      dt_annos: List[Dict]) -> Dict[str, float]:
    """Seconds of each stage of ``eval_class`` for metric 2 (3D), every
    class, difficulty and overlap regime: the least of ``STAGE_REPEATS``
    passes."""
    runs = [_stages_once(gt_annos, dt_annos) for _ in range(STAGE_REPEATS)]
    return {key: min(run[key] for run in runs) for key in runs[0]}


def profile_top(gt_annos: List[Dict], dt_annos: List[Dict],
                top: int = PROFILE_TOP) -> List[Dict]:
    """The ``top`` functions by cumulative time of one end-to-end
    ``kitti_eval`` under cProfile."""
    prof = cProfile.Profile()
    prof.enable()
    kitti_eval(gt_annos, dt_annos, CLASSES)
    prof.disable()
    stats = pstats.Stats(prof).stats
    return [{"func": f"{os.path.basename(fname)}:{line}:{func}",
             "calls": nc, "tottime_s": round(tt, 3),
             "cumtime_s": round(ct, 3)}
            for (fname, line, func), (_, nc, tt, ct, _) in sorted(
                stats.items(), key=lambda kv: -kv[1][3])[:top]]


def eval_period(ap_s: float, train_ms_per_step: float) -> Dict[str, float]:
    """The evaluation's share of one ``EVAL_PERIOD`` of the shipped config:
    its steps at ``train_ms_per_step`` plus the evaluation itself."""
    steps = EVAL_PERIOD_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH)
    train_s = steps * train_ms_per_step / 1e3
    return {"epochs": EVAL_PERIOD_EPOCHS, "steps": steps,
            "batch": TRAIN_BATCH, "train_ms_per_step": train_ms_per_step,
            "train_s": train_s, "eval_s": ap_s,
            "eval_share": ap_s / (train_s + ap_s)}


def host_label() -> Dict[str, Optional[str]]:
    """The host's CPU model and count, and the card's name and power limit
    where there is a card (else null)."""
    cpu = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((line.split(":", 1)[1].strip() for line in f
                        if line.startswith("model name")), cpu)
    except OSError:
        pass
    card = (device_label(torch.device("cuda", 0))
            if torch.cuda.is_available() else None)
    return {"host": f"{cpu}, {len(os.sched_getaffinity(0))} CPUs",
            "card": card}


def jax_ap(images: int, seed: int) -> Optional[Dict[str, float]]:
    """The JAX package's AP dict on ``synth_annos(images, seed)`` where the
    committed record was made at those, else None."""
    record = json.loads(JAX_AP.read_text())
    if (record["images"], record["seed"]) != (images, seed):
        return None
    return record["ap"]


def run(images: int = 3769, seed: int = 0, profile: bool = False,
        train_ms_per_step: Optional[float] = None
        ) -> Tuple[Dict, Dict[str, float]]:
    """(the record, the AP dict) of one run; prints as it goes."""
    t0 = time.perf_counter()
    gt_annos, dt_annos = synth_annos(images, seed)
    print(f"synth annos: {images} images, "
          f"{sum(len(a['name']) for a in gt_annos)} gt / "
          f"{sum(len(a['name']) for a in dt_annos)} dt objects "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    record = {"images": images, "seed": seed, "device": host_label()}

    get_lib()   # the C++ matcher: built before the clock starts
    t0 = time.perf_counter()
    _, ap = kitti_eval(gt_annos, dt_annos, CLASSES)
    record["end_to_end_cpp_s"] = time.perf_counter() - t0
    record["ap_keys"] = len(ap)
    print(f"kitti_eval end-to-end (C++ matcher): "
          f"{record['end_to_end_cpp_s']:.3f}s [{len(ap)} metric keys]",
          flush=True)
    want = jax_ap(images, seed)
    record["ap_equals_jax"] = None if want is None else ap == want
    if want is not None:
        print(f"AP dict against the JAX package's: "
              f"{'equal' if ap == want else 'DIFFERENT'} ({len(want)} keys)",
              flush=True)

    if profile:
        record["profile_top"] = profile_top(gt_annos, dt_annos)
        print("cProfile top cumulative (end-to-end kitti_eval):")
        for row in record["profile_top"][:25]:
            print(f"  {row['cumtime_s']:7.2f} cum {row['tottime_s']:7.2f} "
                  f"tot {row['calls']:>8} {row['func']}")

    record["stages_3d"] = stage_attribution(gt_annos, dt_annos)
    record["stage_repeats"] = STAGE_REPEATS
    print(f"stage attribution (3D metric, all cls x diff x 2 regimes; the "
          f"least of {STAGE_REPEATS} repeats):")
    for key, value in record["stages_3d"].items():
        print(f"  {key:>38}: {value:.6f}")

    if train_ms_per_step is not None:
        record["eval_period"] = period = eval_period(
            record["end_to_end_cpp_s"], train_ms_per_step)
        print(f"one EVAL_PERIOD ({period['epochs']} epochs, "
              f"{period['steps']} steps of B={period['batch']} at "
              f"{train_ms_per_step:.3f} ms): {period['train_s']:.1f} s of "
              f"training + {period['eval_s']:.3f} s of AP; the AP's share "
              f"{period['eval_share']:.4%}", flush=True)
    return record, ap


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", type=int, default=3769)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--json", default="",
                        help="also write the record to this file")
    parser.add_argument("--profile", action="store_true",
                        help="cProfile a second end-to-end kitti_eval and "
                             f"record its top {PROFILE_TOP} functions")
    parser.add_argument("--train-ms-per-step", type=float, default=None,
                        help="the shipped config's train ms/step (bf16, "
                             "B=16), for the AP's share of an EVAL_PERIOD")
    args = parser.parse_args(argv)
    record, _ = run(args.images, args.seed, args.profile,
                    args.train_ms_per_step)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(record, f, indent=1)
        print(f"-> {args.json}")
    return 1 if record["ap_equals_jax"] is False else 0


if __name__ == "__main__":
    sys.exit(main())
