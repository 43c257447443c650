#!/usr/bin/env python3
"""What the train loader's threads cost the train loop, on one NVIDIA GPU.

    python3 loop_breakdown.py

Writes ``chip_smoke``'s synthetic KITTI tree (64 train images at
375x1242) and trains DLA-34 on it through ``MonoConEngine`` with the
defaults (batch 8, canvas 384x1248, 320x960 crops, augmentation, uint8
transport, float32, TF32 off). After one warm-up epoch it runs three
kinds of epoch, each ``EPOCHS`` times, in turn (loop, replay, drain,
loop, ...), so that a slow spell of the host reaches all three alike:

- ``loop``: ``train_one_epoch`` fed by its loader (4 threads), host clock
  from its first batch's arrival to the end of its last step (the
  epoch's loss read-back synchronises), with its wait for batches 2-8;
- ``replay``: the same engine on 8 batches already on the card, no loader
  thread at work;
- ``drain``: ``replay`` while another thread drains the loader and drops
  its batches: the loader's work beside the loop, without the loop
  taking its batches.

Prints the card's name and power limit, one JSON object per epoch, and
as the last line one JSON object with each kind's median, least and
greatest ms/step and the loop's and drain's medians over replay's. Needs
a CUDA device.
"""

from __future__ import annotations

import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

import chip_smoke as smoke

EPOCHS = 8    # timed epochs of each kind: about 80 s on an H100


class Replay:
    """A train loader that yields the same list of batches every epoch."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def drained(loader, first_epoch: int, stop: threading.Event) -> None:
    """Iterate ``loader`` epoch after epoch, dropping its batches, until
    ``stop`` is set."""
    epoch = first_epoch
    while not stop.is_set():
        loader.set_epoch(epoch)
        for _ in loader:
            if stop.is_set():
                break
        epoch += 1


def main() -> int:
    import torch

    from monocon_tpu_torch import MonoConEngine
    from monocon_tpu_torch.data.synthetic import generate_kitti_dataset

    if not torch.cuda.is_available():
        print("loop_breakdown: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.phase_environment()
    smoke.phase_build()
    steps = smoke.LOOP_STEPS

    with tempfile.TemporaryDirectory() as tmp:
        root, out = Path(tmp) / "kitti_train", Path(tmp) / "run"
        generate_kitti_dataset(str(root), num_train=smoke.LOOP_TRAIN_IMAGES,
                               num_val=smoke.LOOP_VAL_IMAGES,
                               image_hw=smoke.EVAL_IMAGE_HW,
                               seed=smoke.SEED + 4)
        cfg = smoke.loop_cfg(root, out, smoke.SEED)
        cfg.SOLVER.OPTIM.NUM_EPOCHS = 1 + 3 * EPOCHS
        cfg.PERIOD.CKPT_PERIOD_STEPS = 0
        cfg.PERIOD.EVAL_PERIOD = -1
        cfg.PERIOD.LOG_PERIOD = steps
        engine = MonoConEngine(cfg, autotune=False)
        loader = engine.train_loader
        waited = smoke.LoaderWait(loader)

        def epoch_seconds(train_loader) -> float:
            engine.train_loader = train_loader
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.train_one_epoch()
            engine.epochs += 1
            return time.perf_counter() - t0

        epoch_seconds(loader)       # warm-up: cuDNN's first calls
        loader.set_epoch(0)
        batches = list(loader)
        runs = {"loop": [], "replay": [], "drain": []}
        for k in range(EPOCHS):
            n = len(waited.waits)
            loop_s = epoch_seconds(waited)
            waits = waited.waits[n:]
            loop_s -= waits[0]
            runs["loop"].append(loop_s)
            smoke.log(json.dumps({
                "epoch": k, "kind": "loop", "ms_per_step":
                loop_s * 1e3 / steps, "first_batch_s": waits[0],
                "wait_s": sum(waits[1:steps])}))

            runs["replay"].append(epoch_seconds(Replay(batches)))
            smoke.log(json.dumps({
                "epoch": k, "kind": "replay",
                "ms_per_step": runs["replay"][-1] * 1e3 / steps}))

            stop = threading.Event()
            drainer = threading.Thread(
                target=drained, args=(loader, 1000 * (k + 1), stop))
            drainer.start()
            try:
                runs["drain"].append(epoch_seconds(Replay(batches)))
            finally:
                stop.set()
                drainer.join()
            smoke.log(json.dumps({
                "epoch": k, "kind": "drain",
                "ms_per_step": runs["drain"][-1] * 1e3 / steps}))
        if not all(np.isfinite(v) for v in engine.entire_losses):
            raise AssertionError("non-finite loss")

    ms = {kind: np.asarray(v) * 1e3 / steps for kind, v in runs.items()}
    summary = {kind: {"median": float(np.median(v)), "min": float(v.min()),
                      "max": float(v.max())} for kind, v in ms.items()}
    summary["epochs"] = EPOCHS
    summary["loop_over_replay"] = (summary["loop"]["median"]
                                   / summary["replay"]["median"])
    summary["drain_over_replay"] = (summary["drain"]["median"]
                                    / summary["replay"]["median"])
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
