"""A cell shrunk to a size the CPU runs in seconds, for the tests: batch
4 (at batch 2 the attention's BatchNorm over a batch of two leaves its
gradient to rounding), 90x300 images on a 96x320 canvas, a crop of
64x256, three batches, held to limits of this size (``TINY_LIMITS``)."""

from __future__ import annotations

import copy
from typing import Dict

from perfbench import run


# Limits at the small size on the CPU, in float32 (the configurations'
# own come from card readings at the cells' size). Sound runs of seeds
# 5-11 read loss_gap1 up to 7.8e-4, grad_gap up to 0.10 and update_gap up
# to 0.16 (DLA-102 and DLA-34: BatchNorm over 4 small images lets
# float32 rounding grow); the mirrored conv2 read loss_gap1 from 2.9e-3,
# half of the batch from 0.27, an unchanged state update_gap 1.
TINY_LIMITS = {"batch_diff": 0, "loss_gap1": 2e-3, "grad_gap": 0.3,
               "update_gap": 0.5}


def tiny_spec(workload: str, dtype: str = "float32") -> Dict:
    spec = copy.deepcopy(run.cell_spec(workload))
    spec["config"]["cfg"].update({
        "DATA.BATCH_SIZE": 4, "DATA.NUM_WORKERS": 2,
        "DATA.CROP_HW": [64, 256], "TPU.PAD_HW": [96, 320],
        "TPU.COMPUTE_DTYPE": dtype})
    spec["config"]["dtype"] = dtype
    spec["config"]["data"].update({"image_hw": [90, 300], "max_objects": 6})
    spec["traffic"].update(ring_batches=3, trace_steps=2)
    spec["config"]["limits"] = dict(TINY_LIMITS)
    return spec
