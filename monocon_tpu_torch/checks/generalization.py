"""Generalization check: train on 200 synthetic KITTI images, evaluate AP40
on 100 held-out ones.

    python -m monocon_tpu_torch.checks.generalization [--epochs 250]
        [--train 200] [--val 100] [--batch 16] [--augment]
        [--dtype float32|bfloat16] [--seed 0] [--snapshot-eval 3]
        [--out DIR] [--set KEY VALUE ...] [--device cpu]

Port of the JAX package's ``scripts/generalization_check.py``, with its
config: a synthetic tree at 192x640 (dataset seed 11, fixed across training
seeds) written to ``{out}/kitti``, the 192x640 canvas, 160x512 crops when
``--augment`` keeps the train-time augmentation, no evaluation during
training, a log line every 10 steps, the decoded-image cache, no ImageNet
backbone, and a checkpoint every 10 epochs so that late snapshots exist.
``--set`` sets one config key after these (as the train CLI's does).
Training runs in this process through ``MonoConEngine`` with the train
CLI's CUDA settings (``train.configure_backends``). The val split is
disjoint from the train split, so nonzero AP here shows that the
train -> decode -> AP pipeline learns structure that transfers.

The headline numbers are per-key medians over the final model and the
last K ``epoch_*`` checkpoints (``--snapshot-eval K``): stopping-epoch AP
swings by several points between neighbouring checkpoints of one run, so
runs are compared by these medians. The record ``{out}/ap_seed{seed}.json``
holds the JAX script's keys plus ``device`` (the card's name and power
limit) and ``wall_s`` (this invocation's). PASS iff the final model's
``Car_2D_AP40_moderate_strict`` exceeds 5; the exit code is 0 on PASS.

A run cut short and started again with the same ``--out`` carries on from
its latest checkpoint (the engine's auto-resume); once the final
checkpoint exists, a re-run only evaluates.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..config import get_default_cfg
from ..data.synthetic import generate_kitti_dataset
from ..device import resolve_device
from ..engine.engine import MonoConEngine
from ..train import configure_backends, set_key
from . import device_label

IMAGE_HW, CROP_HW = (192, 640), (160, 512)
DATASET_SEED = 11
PASS_KEY = "img_bbox/KITTI/Car_2D_AP40_moderate_strict"
PASS_LIMIT = 5.0
# The AP entries printed for each class: "multi-class training" shows only
# if Pedestrian and Cyclist reach nonzero held-out AP too.
HEADLINE_KEYS = [
    f"img_bbox/KITTI/{cls}_{kind}"
    for cls in ("Car", "Pedestrian", "Cyclist")
    for kind in ("2D_AP40_moderate_strict", "3D_AP40_moderate_loose",
                 "3D_AP40_moderate_strict")
] + ["img_bbox/KITTI/Overall_3D_AP40_moderate"]


def snapshot_medians(results: Dict[str, float],
                     snapshots: Dict[str, Dict[str, float]]
                     ) -> Dict[str, float]:
    """Per key of the snapshots: the median over the snapshots holding it
    and the final ``results``' value where it has one."""
    keys = {k for snap in snapshots.values() for k in snap}
    medians = {}
    for key in sorted(keys):
        values = [snap[key] for snap in snapshots.values() if key in snap]
        if key in results:
            values.append(float(results[key]))
        medians[key] = float(np.median(values))
    return medians


def late_checkpoints(weight_dir: str, count: int) -> List[str]:
    """The last ``count`` ``epoch_*`` checkpoint directories, the final one
    left out."""
    if count <= 0:
        return []
    paths = sorted(p for p in glob.glob(os.path.join(weight_dir, "epoch_*"))
                   if not p.endswith("_final"))
    return paths[-count:]


def loop_speed(metrics_path: str) -> Tuple[int, float, float]:
    """(epochs, median ms/step, median images/s) of the ``time`` rows in a
    run's metrics file, the first epoch (cuDNN's first calls) left out."""
    rows = []
    with open(metrics_path) as f:
        for line in f:
            row = json.loads(line)
            if row["tag"] == "time" and row["step"] > 1:
                rows.append(row)
    if not rows:
        return 0, float("nan"), float("nan")
    return (len(rows), float(np.median([r["ms_per_step"] for r in rows])),
            float(np.median([r["images_per_s"] for r in rows])))


def check_config(root: str, out: str, epochs: int, train: int, batch: int,
                 augment: bool, dtype: str, seed: int, snapshot_eval: int,
                 image_hw: Sequence[int], crop_hw: Sequence[int],
                 sets: Iterable[Tuple[str, str]] = ()):
    """The JAX script's config (``scripts/generalization_check.py:62-88``),
    then each ``(key, value)`` of ``sets``."""
    cfg = get_default_cfg()
    cfg.DATA.ROOT = root
    cfg.OUTPUT_DIR = out
    cfg.DATA.BATCH_SIZE = batch
    cfg.DATA.NUM_WORKERS = 4
    cfg.SOLVER.OPTIM.NUM_EPOCHS = epochs
    cfg.PERIOD.EVAL_PERIOD = -1
    cfg.PERIOD.LOG_PERIOD = 10
    cfg.SEED = seed
    cfg.TPU.PAD_HW = list(image_hw)
    cfg.DATA.CROP_HW = list(crop_hw)
    cfg.DATA.AUGMENT = bool(augment)
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.DATA.IMAGE_CACHE = "auto"
    cfg.MODEL.BACKBONE.IMAGENET_PRETRAINED = False
    if snapshot_eval > 0:
        cfg.PERIOD.CKPT_PERIOD_STEPS = 10 * -(-train // batch)
    for key, value in sets:
        set_key(cfg, key, value)
    return cfg


def run_generalization(out: str, epochs: int = 250, train: int = 200,
                       val: int = 100, batch: int = 16,
                       augment: bool = False, dtype: str = "float32",
                       seed: int = 0, snapshot_eval: int = 3,
                       device: "str | torch.device | None" = None,
                       sets: Iterable[Tuple[str, str]] = (),
                       image_hw: Sequence[int] = IMAGE_HW,
                       crop_hw: Sequence[int] = CROP_HW) -> Dict[str, Any]:
    """Write the tree, train (or carry on training) under ``out``, evaluate
    the final model and the late snapshots, write and return the record."""
    start = time.perf_counter()
    device = resolve_device(device)
    root = os.path.join(out, "kitti")
    generate_kitti_dataset(root, num_train=train, num_val=val,
                           image_hw=tuple(image_hw), seed=DATASET_SEED)
    print(f"synthetic dataset ({train} train / {val} val) in "
          f"{time.perf_counter() - start:.0f}s -> {root}", flush=True)

    cfg = check_config(root, out, epochs, train, batch, augment, dtype, seed,
                       snapshot_eval, image_hw, crop_hw, sets)
    autotune = configure_backends(cfg, deterministic=False)
    engine = MonoConEngine(cfg, device=device, autotune=autotune)
    if engine.epochs <= engine.target_epochs:
        engine.train()
    else:
        print(f"training is complete in '{out}': evaluating only",
              flush=True)

    results = engine.evaluate(verbose=True)
    print("\nheld-out AP40 (synthetic val, disjoint from train):")
    for key in HEADLINE_KEYS:
        if key in results:
            print(f"  {key}: {results[key]:.2f}")
    nonzero = sum(1 for k, v in results.items()
                  if k.startswith("img_bbox/") and v > 0)
    print(f"({nonzero} nonzero held-out AP entries)")

    snapshots = {}
    paths = late_checkpoints(engine.weight_dir, snapshot_eval)
    if paths:
        print("\nlate-training snapshot evals (within-run AP spread):")
        print("  {:>8} {:>10} {:>14}".format("epoch", "Car_2D_mod",
                                             "Car_3D_mod@0.5"))
    for path in paths:
        engine.load_checkpoint(path)
        snap = engine.evaluate(verbose=False)
        epoch = os.path.basename(path).split("_")[1]
        snapshots[epoch] = {k: float(v) for k, v in snap.items()
                            if "_AP40_moderate" in k}
        print(f"  {epoch:>8} {snap.get(PASS_KEY, 0.0):>10.2f} "
              f"{snap.get('img_bbox/KITTI/Car_3D_AP40_moderate_loose', 0.0):>14.2f}")

    medians = snapshot_medians(results, snapshots)
    if medians:
        print(f"\nmedian over final + last {len(snapshots)} snapshots "
              "(the comparable numbers):")
        for key in HEADLINE_KEYS:
            if key in medians:
                print(f"  {key}: {medians[key]:.2f}")
    timed, ms_per_step, images_per_s = loop_speed(
        os.path.join(engine.writer_dir, "metrics.jsonl"))
    print(f"loop: median {ms_per_step:.2f} ms/step, {images_per_s:.2f} "
          f"images/s over {timed} epochs (the first left out)")

    record = {
        "seed": seed, "train": train, "val": val, "epochs": epochs,
        "augment": bool(augment), "dtype": dtype, "batch": batch,
        "results": {k: float(v) for k, v in results.items()},
        "snapshots": snapshots, "median_results": medians,
        "device": device_label(device),
        "wall_s": time.perf_counter() - start,
    }
    path = os.path.join(out, f"ap_seed{seed}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
    print(f"full AP record -> {path}")
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=250)
    parser.add_argument("--train", type=int, default=200)
    parser.add_argument("--val", type=int, default=100)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--augment", action="store_true",
                        help="keep the full train-time augmentation (needs "
                             "far more epochs to converge)")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--seed", type=int, default=0,
                        help="training seed (init, shuffle, augmentation); "
                             "the dataset stays fixed")
    parser.add_argument("--snapshot-eval", type=int, default=3, metavar="K",
                        help="also evaluate the last K checkpoints (every "
                             "10 epochs); 0 disables")
    parser.add_argument("--out", default="",
                        help="output directory; a run there is resumed")
    parser.add_argument("--set", nargs=2, action="append", default=[],
                        metavar=("KEY", "VALUE"),
                        help="set a config key, e.g. --set "
                             "TPU.GRAD_ACCUM_STEPS 2")
    parser.add_argument("--device", default=None,
                        help="run on this device instead of the card, "
                             "e.g. cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    out = args.out or tempfile.mkdtemp(prefix="mc_gen_out_")
    record = run_generalization(
        out, args.epochs, args.train, args.val, args.batch, args.augment,
        args.dtype, args.seed, args.snapshot_eval, device, args.set)
    passed = record["results"].get(PASS_KEY, 0.0) > PASS_LIMIT
    print("GENERALIZATION CHECK:", "PASS" if passed else "FAIL",
          f"(checkpoints in {out})")
    return 0 if passed else 1


if __name__ == "__main__":
    sys.exit(main())
