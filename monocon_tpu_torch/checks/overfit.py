"""Convergence smoke check: overfit 4 synthetic images and confirm that the
whole pipeline (targets -> gradients -> optimizer -> decode -> KITTI AP)
coheres.

    python -m monocon_tpu_torch.checks.overfit [--steps 4000] [--lr 5e-4]
        [--dtype float32|bfloat16] [--device cpu]

Port of the JAX package's ``scripts/overfit_check.py``, with its recipe:
4 train images of a synthetic tree at 192x640 (seed 21), one batch of 4
(Normalize, Pad(32), no augmentation) kept on the device, ``steps``
``train_step`` calls under the one-cycle schedule, then an eval forward,
``decode_predictions`` and KITTI AP40 on the same 4 images at score 0.05.
The rule is the JAX script's: PASS iff at least one AP entry is nonzero
and the last step's ``loss_center_heatmap`` is under 0.1; the exit code
is 0 on PASS, 1 on FAIL. With 1-2 valid objects per class, 2.5 is the
largest AP40 an entry reaches (the 41-point protocol undersamples tiny
sets). ``--dtype bfloat16`` trains through the detector's autocast, as
``TPU.COMPUTE_DTYPE`` does.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..data.loader import DataLoader, use_on_current_stream
from ..data.monocon_dataset import MonoConDataset
from ..data.synthetic import generate_kitti_dataset
from ..data.transforms import Normalize, Pad
from ..device import resolve_device
from ..engine.engine import dispatch_detection, fetch_detection
from ..engine.train_step import train_step
from ..models.detector import conv_memory_format, create_detector
from ..solver.schedule import build_optimizer
from ..utils.convert import (convert_to_kitti_2d, convert_to_kitti_3d,
                             split_batch_detections)
from . import device_label

IMAGE_HW = (192, 640)
BATCH = 4
SCORE_THRESHOLD = 0.05
HEATMAP_LIMIT = 0.1
LOG_EVERY = 1000


def write_tree(root: str, image_hw: Tuple[int, int] = IMAGE_HW) -> None:
    """The check's synthetic tree: 4 train and 4 val images, seed 21."""
    generate_kitti_dataset(root, num_train=BATCH, num_val=BATCH,
                           image_hw=image_hw, seed=21)


def overfit_passed(final_losses: Dict[str, float],
                   ap: Dict[str, float]) -> bool:
    """The JAX script's rule: some AP entry above 0 and the center
    heatmap's loss under 0.1."""
    return (any(v > 0 for v in ap.values())
            and final_losses["loss_center_heatmap"] < HEATMAP_LIMIT)


def overfit_batch(root: str, device: torch.device,
                  image_hw: Tuple[int, int] = IMAGE_HW):
    """(the dataset, the first batch as the loader gives it, its tensors
    on ``device``): the tree's 4 train images, Normalize and Pad(32),
    padded to ``image_hw``."""
    dataset = MonoConDataset(root, "train", transforms=[Normalize(), Pad(32)])
    loader = DataLoader(dataset, device, batch_size=BATCH, shuffle=False,
                        num_workers=2, pad_hw=tuple(image_hw), seed=0,
                        labels=True)
    batches = iter(loader)
    host = next(batches)
    batches.close()
    return dataset, host, use_on_current_stream(host)


def run_overfit(root: str, steps: int = 4000, lr: float = 5e-4,
                dtype: str = "float32",
                device: "str | torch.device | None" = None,
                image_hw: Tuple[int, int] = IMAGE_HW,
                model: Optional[torch.nn.Module] = None,
                on_step: Optional[Callable[..., None]] = None,
                autotune: bool = False) -> Dict[str, Any]:
    """Train ``steps`` steps on the first batch of the tree at ``root`` (see
    :func:`write_tree`), padded to ``image_hw``, then evaluate it. ``model``
    replaces the detector from seed 0 (its ``compute_dtype`` then rules,
    not ``dtype``). ``on_step(i, losses, solver)``, where given, is called
    after each step (``overfit_breakdown.py`` reads the run through it).
    ``autotune``: whether cuDNN autotunes the process's convolutions, which
    picks the detector's memory format (``conv_memory_format``).

    Returns ``log`` (the 11 losses of steps 0, 1000, 2000, ...), ``final``
    (those of the last step, taken before its update), ``nonzero_ap``
    (the AP entries above 0), ``detections`` (per image, score > 0.05),
    ``passed`` (:func:`overfit_passed`), ``train_s`` (the steps' wall,
    ended by a synchronisation) and ``ms_per_step``."""
    device = resolve_device(device)
    dataset, host, batch = overfit_batch(root, device, image_hw)
    if model is None:
        compute_dtype = (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
        model = create_detector(
            generator=torch.Generator().manual_seed(0), device=device,
            compute_dtype=compute_dtype, memory_format=conv_memory_format(
                device, compute_dtype, autotune))
    optimizer, solver = build_optimizer(model.parameters(), lr=lr,
                                        total_steps=steps,
                                        use_scheduler=True)
    log = []
    start = time.perf_counter()
    for i in range(steps):
        losses = train_step(model, optimizer, solver, batch)
        if on_step is not None:
            on_step(i, losses, solver)
        if i % LOG_EVERY == 0:
            log.append({k: float(v) for k, v in losses.items()})
            print(f"step {i}: total={log[-1]['total_loss']:.3f}", flush=True)
    final = {k: float(v) for k, v in losses.items()}
    train_s = time.perf_counter() - start
    print("final:", {k: round(v, 3) for k, v in final.items()})

    model.eval()
    decoded = fetch_detection(dispatch_detection(
        model, batch["img"], batch["img_hw"], batch["p2"]))
    per_image = split_batch_detections(decoded, SCORE_THRESHOLD)
    detections = [len(p["scores"]) for p in per_image]
    print("detections per image:", detections)
    ap = dataset.evaluate({
        "img_bbox": convert_to_kitti_3d(per_image, host["img_metas"],
                                        host["calib"]),
        "img_bbox2d": convert_to_kitti_2d(per_image, host["img_metas"]),
    }, verbose=False)
    nonzero = {k: v for k, v in ap.items() if v > 0}
    print(f"nonzero AP entries: {len(nonzero)}")
    for key in sorted(nonzero):
        print(f"  {key}: {nonzero[key]}")
    return {"log": log, "final": final, "nonzero_ap": nonzero,
            "detections": detections, "passed": overfit_passed(final, ap),
            "train_s": train_s, "ms_per_step": 1e3 * train_s / steps}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="'bfloat16' checks the mixed-precision "
                             "training path (TPU.COMPUTE_DTYPE)")
    parser.add_argument("--device", default=None,
                        help="run on this device instead of the card, "
                             "e.g. cpu")
    args = parser.parse_args(argv)

    from ..config import get_default_cfg
    from ..train import configure_backends

    device = resolve_device(args.device)
    autotune = configure_backends(get_default_cfg(), deterministic=False)
    print(f"device: {device_label(device)}", flush=True)
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="overfit_") as root:
        write_tree(root)
        result = run_overfit(root, args.steps, args.lr, args.dtype, device,
                             autotune=autotune)
    print(f"{args.steps} steps in {result['train_s']:.1f} s "
          f"({result['ms_per_step']:.2f} ms/step); wall "
          f"{time.perf_counter() - start:.1f} s")
    print("CONVERGENCE CHECK:", "PASS" if result["passed"] else "FAIL")
    return 0 if result["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
