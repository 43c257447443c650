#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``monocon_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for convolutions and matrix products;
2. build: compiles ``monocon_tpu_torch/csrc/splat.cu`` with nvcc;
3. kernel vs plain: the splat kernel against its plain PyTorch version on
   the card, on the isolated train step's own inputs at 384x1280 (B=8,
   feature map 96x320: C=3 N=30 and C=9 N=270), timed, on dense random
   instances at the same shapes and on edge cases (boxes on each side of a tile border, ragged
   W and H, N above one cull round, N above 48 KB of shared list, one
   channel, N=0, radius 0, an all-invalid element), and an N past the
   shared list must be refused; then every target of one train batch,
   card against CPU; then the batch-norm kernels (``ops/batch_norm.py``)
   and ``F.batch_norm`` in float32 at three of the float32 step's shapes
   and two ragged ones, both against ``F.batch_norm`` in float64, and the
   kernels' forward and backward timed against their bytes bound;
4. serve: DLA-34 (random weights from a seed) at 384x1280, float32, eval
   forward + 3D decode, one image on the card against the CPU, then
   frames/s at batch 8;
5. train: one step at 64x160 on the card against the CPU, then five
   ``train_step``s at 384x1280, B=8, uint8 images; the splat kernel must
   launch twice per step;
6. eval: a synthetic KITTI val split of 256 images at 375x1242 written by
   the port's generator, DLA-34 (random weights from a seed, center-heatmap
   bias 0.5) saved as a reference ``.pth`` and evaluated by
   ``MonoConEngine`` on the card (canvas 384x1248, batch 8, float32):
   the 84-key AP dict, PNG decode ms per image, the loader's images/s, the
   collect loop's frames/s, its wait for the loader, the AP stage's
   seconds, the forward+decode event span share (an upper bound on the
   card's busy share) and the busy share from a torch.profiler trace (a
   lower bound); every image's KITTI annotations from the timed, pipelined
   loop against the same model run with nothing overlapped; the first
   batch's annotations card against CPU. The eval path runs no hand
   kernel;
7. train loop: a synthetic KITTI tree of 64 train and 16 val images at
   375x1242; DLA-34 at batch 8 on the 384x1248 canvas, 320x960 crops,
   the default augmentations, uint8 transport, float32:
   A, one epoch through ``python -m monocon_tpu_torch.train
   --deterministic`` in a subprocess (a checkpoint every 4 steps, an
   evaluation after the epoch); B, the same in this process through
   ``MonoConEngine``, cut after the step-4 checkpoint; C, a fresh engine
   with another SEED that resumes B's checkpoint and finishes. C's final
   ``state.pth`` (weights, AdamW state, schedule) and loss history must
   equal A's bit for bit (deterministic algorithms, cuBLAS workspace set
   before any CUDA use); the splat kernel launches twice per step; every
   loss is finite; both evaluations give 84 finite AP keys. Then D, two
   epochs through ``MonoConEngine.train()`` with the default
   (non-deterministic) algorithms: ms/step and images/s of epoch 2 (host
   clock), epoch 1 (cuDNN's first calls) apart, the loop's wait for the
   loader, peak device memory, a checkpoint's save seconds and bytes; the
   augmented loader alone (4 threads); the splat kernel on the two calls
   of one of its augmented batches (feature map 96x312), against its
   plain version and timed; and ``PhotometricDistortion`` ms per image
   (one thread). ``loop_breakdown.py`` times the loop against the same
   engine with no loader thread at work, over more epochs;
8. configurations (bfloat16, DLA-102, the shipped config file): bfloat16
   DLA-34, one 64x160 image and one 2x64x160 train step on the card
   against the CPU in bfloat16, each head map and loss within 3x the
   CPU's own bfloat16-to-float32 gap (the bound of
   ``tests/test_torch_bf16.py``), then serve frames/s at batch 8 and train
   ms/step and peak memory at batch 8 and 16, 384x1280, uint8 images,
   with cuDNN's heuristics and then autotuned, float32 beside it (autotuned:
   in contiguous NCHW, the batch-norm kernels launched 4 times a step for
   each train-mode BatchNorm2d, and none in channels_last), and a
   torch.profiler breakdown of one step of each at batch 8;
   DLA-102 at 64x160 card against CPU in float32 and bfloat16, then serve
   frames/s and train ms/step in both at 384x1280, batch 8 (halved if the
   card's memory refuses it); ``python -m monocon_tpu_torch.train
   --config_file configs/kitti_v5e.yaml`` in a subprocess with PyYAML,
   OpenCV and PIL refused, on the train-loop phase's tree (bfloat16, batch
   16, two micro-steps per optimizer step, an evaluation): the schedule
   count after 4 batches is 2, the splat kernel launches 8 times, every
   loss is finite, 84 finite AP keys, and its wall time. The splat kernel
   launches twice per micro-batch on every training path;
9. streaming and visualization: a synthetic drive of 96 frames at
   375x1242 written as PNG with a ``calib_cam_to_cam.txt``; DLA-34 float32
   with the serve phase's random weights streams it through
   ``KITTIRawDataset``, ``BatchedFrames`` and ``pipelined_frames`` at B=1
   and B=8 (frames/s end to end, the loop's wait for frame loading), and
   unpipelined at both (the median per-frame wall at B=1 is the latency);
   every frame's 2D and 3D vis result of each pipelined run equals its
   unpipelined run's (labels exact, boxes within rtol 1e-6 / atol 1e-6);
   ``python -m monocon_tpu_torch.test_raw --batch 8 --score_threshold 0``
   and ``python -m monocon_tpu_torch.test --visualize`` (16 images of the
   eval phase's tree) in subprocesses with OpenCV, PIL and PyYAML refused
   write every expected PNG (read back with ``read_png``); the export's
   seconds per frame and the visualize run's wall time. The splat kernel
   launches 0 times on these paths;
10. kernels line: one JSON object per hand-written kernel. ``launches`` is
   the count of run D, ``launches_by_path`` that of each path; ``ms``,
   ``plain_ms``, ``bound_ms`` and ``per_call`` are those of run D's
   batch (96x312), ``per_call_train_step`` those of the isolated step
   (96x320), ``per_call_overfit`` those of phase 14's batch (48x160);
   ``max_abs_err`` is the largest of every comparison. The batch-norm
   kernels' entry: ``per_call`` the checked shapes, ``ms`` and
   ``bound_ms`` per step of the autotuned float32 step, ``launches`` its
   count; every other path of the process must launch none;
11. parallel: a. a process group of one rank through NCCL (torchrun's
   environment set in this process): the DLA-34 float32 step at B=8,
   384x1280, under ``data_parallel`` (DistributedDataParallel) against
   the plain step from the same weights and batch, in turns (plain, DDP,
   DDP, plain): 11 losses within rtol 1e-3 / atol 1e-4, ms/step and peak
   memory of each; b. two ranks on the one card through gloo (NCCL
   refuses two ranks on one device), each in a process of its own with
   4 rows of the same B=8 batch: the global losses against the plain
   step's, parameters bit-equal across the ranks after the steps (SHA-256
   of their bytes), ms/step and peak memory per rank; c. ``torchrun
   --nproc_per_node 1 -m monocon_tpu_torch.train`` (OpenCV, PIL and PyYAML
   refused) on the train-loop phase's tree: one epoch, finite losses, 84
   finite AP keys, one set of checkpoints. The splat kernel launches
   twice per step on every rank;
12. bench and profiling: ``python -m monocon_tpu_torch.bench`` at its
   defaults (B=128, bf16) and with ``BENCH_DTYPE=float32 BENCH_BATCH=8``,
   each JSON line printed, ``mfu_pct`` in (0, 100]; the kernel seconds
   that ``device_op_seconds`` reads from a ``device_trace`` of a serve loop
   positive and at most 1.05x the CUDA-event time of the same loop;
13. spatial: the image height split over two ranks on the one card
   through gloo (a 1 data x 2 space layout, ``parallel/spatial.py``),
   each in a process of its own with its 192-row band of the same B=8
   batch at 384x1280, DLA-34 float32: 4 train steps (the first not
   timed), the global losses within rtol 1e-3 / atol 1e-4 of the plain
   step's (phase 11a), parameters bit-equal across the ranks, every
   backbone level and the neck's output at band height; before them, the
   banded eval forward + decode against the same model's forward + decode
   of the whole images: head maps within 1e-3, top-30 equal up to ties;
   ms/step and peak memory per rank beside the plain step's. The splat
   kernel launches twice per step on each rank;
14. overfit: the JAX package's overfit check
   (``python -m monocon_tpu_torch.checks.overfit``: 4 synthetic images at
   192x640, one batch of 4 on the card, DLA-34 float32, the one-cycle
   AdamW at LR 5e-4) at ``OVERFIT_STEPS`` steps with the train CLI's CUDA
   settings: its rule must pass (an AP entry above 0 and the last
   step's center-heatmap loss under 0.1), and the splat kernel must launch
   twice per step. Before the counted run, the kernel is held against its
   plain version (within ``SPLAT_TOL``) and timed on the check's batch:
   its two calls at the 48x160 map with the tree's labels. Prints the
   first and last step's losses, the nonzero AP entries, ms/step and the
   wall;
15. eval scale: ``python -m monocon_tpu_torch.checks.eval_scale`` (its
   ``main``, in this process) at 3769 images, KITTI's val split, on the
   card's host: synthetic annotations at KITTI's density, ``kitti_eval``
   end to end with the C++ matcher, the cProfile top 40 of a second run,
   the stage table of ``eval_class`` (metric 3D, the least of 3 repeats)
   and the AP's share of one ``EVAL_PERIOD`` of the shipped config (10
   epochs of 3712 images at B=16) at phase 8's bf16 B=16 ms/step (cuDNN
   autotuned, as the train CLI runs). The 63-key AP dict must equal,
   float for float, the JAX package's on the same annotations (the
   committed ``monocon_tpu_torch/checks/resources/eval_scale_jax_ap.json``).
   A host phase: the splat kernel launches 0 times.

The kernels line is printed after phase 15.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Needs a CUDA device;
without one it exits 1 before any phase.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PAD_HW = (384, 1280)
FEAT_HW = (96, 320)
TRAIN_BATCH = 8
SERVE_BATCH = 8
NUM_OBJ = 30
TRAIN_STEPS = 5
SEED = 0
DEVICE = "cuda"
# H100 SXM: device memory rate and the float32 rate outside the tensor
# cores (NVIDIA data sheet, dense, at the full 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Float32 operations of one Gaussian evaluation at a covered pixel: two
# offsets, two squares, an add, a multiply, the exp, the floor test and
# the max.
SPLAT_OPS_PER_PIXEL = 9
SPLAT_TOL = 1e-6       # kernel against its plain version, max |diff|
# Instances per batch element past the kernel's shared-memory list (20
# bytes each, 227 KB on an H100): the wrapper must refuse them.
TOO_MANY_N = 16384
HEAD_ATOL = 1e-3       # continuous head maps, card against CPU (float32)
EVAL_IMAGES = 256
EVAL_IMAGE_HW = (375, 1242)   # KITTI's image size; the default canvas is
                              # 384x1248 (TPU.PAD_HW)
HEATMAP_BIAS = 0.5     # most top-30 scores clear the 0.4 threshold
DECODE_FILES = 32      # PNGs timed one after another, one thread
ANNO_TOL = dict(rtol=1e-3, atol=1e-3)   # KITTI annotations, card vs CPU
ANNO_FIELDS = ("bbox", "location", "dimensions", "rotation_y", "score")
# The pipelined collect loop against the unpipelined one: the same model
# and inputs on the same card, so only a race could differ.
PIPELINE_TOL = dict(rtol=1e-6, atol=1e-6)
LOOP_TRAIN_IMAGES, LOOP_VAL_IMAGES = 64, 16
LOOP_CKPT_STEPS = 4    # run B stops after this step's checkpoint
LOOP_STEPS = LOOP_TRAIN_IMAGES // TRAIN_BATCH
LOOP_RESUME_SEED = 7   # run C starts with this SEED and must adopt 0
LOOP_TIMED_EPOCHS = 2  # run D: epoch 1 warms up, epoch 2 is timed
PHOTOMETRIC_IMAGES = 16
TRAIN_CLI_TIMEOUT_S = 600
STREAM_FRAMES = 96
STREAM_HW = (375, 1242)
STREAM_BATCHES = (1, 8)
BEV_HW = (600, 1200)
VIS_IMAGES = 16
STREAM_CLI_TIMEOUT_S = 300
# The configurations phase. bfloat16 card against CPU: the bound of
# tests/test_torch_bf16.py, with the port's own CPU bfloat16-to-float32 gap
# in the place of the JAX package's.
BF16_FACTOR = 3.0
BF16_EPS = 2.0 ** -7
SMALL_HW = (64, 160)
BIG_BATCH = 16          # configs/kitti_v5e.yaml's batch
DLA102_REL = 1e-3       # DLA-102 float32 head maps, card against CPU,
                        # relative to each map's largest value
CONFIG_FILE = "configs/kitti_v5e.yaml"
CONFIG_ACCUM = 2
# A port CLI with OpenCV, PIL and PyYAML refused; then prints the splat
# kernel's launches.
REFUSED_RUN = """
import runpy, sys
sys.modules["cv2"] = sys.modules["yaml"] = sys.modules["PIL"] = None
module = sys.argv[1]
sys.argv = [module, *sys.argv[2:]]
try:
    runpy.run_module(module, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
from monocon_tpu_torch.ops import splat
print("SPLAT_LAUNCHES", splat.launch_count)
"""
# The parallel phase: train steps per run (the first is not timed), and
# the two-rank run's time limit.
PARALLEL_STEPS = 4
TWO_RANK_TIMEOUT_S = 300
# The overfit phase's steps: the fewest of 250, 500, 1000, 2000 and 4000
# at which the check passed on an H100 with the center-heatmap loss at most
# half the rule's 0.1 (PERF.md section 6).
OVERFIT_STEPS = 500
# The eval-scale phase: KITTI's val split, and the JAX AP dict's keys.
EVAL_SCALE_IMAGES = 3769
EVAL_SCALE_AP_KEYS = 63
# The bench phase: the root bench.py's keys, and the time limit of a run.
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "torch_fps",
              "device_ms_per_step", "device_fps", "mfu_pct", "batch",
              "dtype"}
BENCH_TIMEOUT_S = 300
# cuBLAS reads it when it creates its first handle: set before any CUDA
# use, so that the deterministic runs can take deterministic products.
CUBLAS_WORKSPACE = ":4096:8"


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, launches: int) -> float:
    """Device milliseconds of one ``fn()``: ``launches`` calls captured in
    a CUDA graph and replayed, so that the host's launch cost, which can
    exceed a small kernel's run time, stays out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, 10) / launches


def host_ms(fn, iters: int) -> float:
    """Host milliseconds to issue one ``fn()`` (no wait for the card)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / iters * 1e3


def random_label_batch(rng, b: int, o: int, pad_hw, num_valid=(3, 8)):
    """Fixed-shape KITTI-like labels (numpy): a few valid objects per image
    in the first slots, keypoints around each box, some off the image."""
    pad_h, pad_w = pad_hw
    label = {
        "gt_bboxes": np.zeros((b, o, 4), np.float32),
        "gt_labels": np.zeros((b, o), np.float32),
        "gt_bboxes_3d": np.zeros((b, o, 7), np.float32),
        "depths": np.zeros((b, o), np.float32),
        "gt_kpts_2d": np.zeros((b, o, 18), np.float32),
        "gt_kpts_valid_mask": np.zeros((b, o, 9), np.float32),
        "mask": np.zeros((b, o), np.float32),
    }
    for bi in range(b):
        for oi in range(int(rng.integers(*num_valid))):
            w = rng.uniform(0.05, 0.4) * pad_w
            h = rng.uniform(0.05, 0.5) * pad_h
            x1 = rng.uniform(0, pad_w - w)
            y1 = rng.uniform(0, pad_h - h)
            label["gt_bboxes"][bi, oi] = [x1, y1, x1 + w, y1 + h]
            label["gt_labels"][bi, oi] = rng.integers(0, 3)
            label["gt_bboxes_3d"][bi, oi] = [
                *rng.normal(0, 5, 2), rng.uniform(5, 60),
                *rng.uniform(0.5, 4.0, 3), rng.uniform(-np.pi, np.pi)]
            label["depths"][bi, oi] = rng.uniform(2, 65)
            kpts = np.stack([rng.normal(x1 + w / 2, w / 2, 9),
                             rng.normal(y1 + h / 2, h / 2, 9)], -1)
            label["gt_kpts_2d"][bi, oi] = kpts.reshape(-1)
            label["gt_kpts_valid_mask"][bi, oi] = rng.choice(
                [0, 1, 2], size=9, p=[0.2, 0.1, 0.7])
            label["mask"][bi, oi] = 1
    return label


def train_batch(rng, b: int, pad_hw, device):
    import torch

    label = random_label_batch(rng, b, NUM_OBJ, pad_hw)
    img = rng.integers(0, 256, (b, *pad_hw, 3), dtype=np.uint8)
    return {"img": torch.from_numpy(img).to(device),
            "label": {k: torch.from_numpy(v).to(device)
                      for k, v in label.items()}}


def random_instances(rng, b, n, c, h, w, radius_max=15):
    """Splat inputs (numpy): centres in -5..w+5 / -5..h+5, 70% valid."""
    centers = np.stack([rng.integers(-5, w + 5, (b, n)),
                        rng.integers(-5, h + 5, (b, n))], -1).astype(np.int32)
    radius = rng.integers(0, radius_max, (b, n)).astype(np.int32)
    chan = rng.integers(0, c, (b, n)).astype(np.int32)
    valid = rng.random((b, n)) < 0.7
    return [centers, radius, chan, valid]


def border_instances(b: int, tile_h: int, tile_w: int):
    """Splat inputs (numpy): one instance per channel, radius 3, each box
    meeting the border between the first and second kernel tile (tile_w
    columns, tile_h rows) in one way: channels 0-3 on columns, ending on
    tile_w - 1, starting on tile_w, reaching one pixel across to tile_w,
    starting one pixel before it; channels 4-7 the same on rows. A cull
    that is off by one drops a whole tile's share of a box."""
    r = 3
    xs = [tile_w - 1 - r, tile_w + r, tile_w - r, tile_w - 1 + r]
    ys = [tile_h - 1 - r, tile_h + r, tile_h - r, tile_h - 1 + r]
    xy = ([(x, tile_h // 2) for x in xs]
          + [(tile_w + tile_w // 2, y) for y in ys])
    centers = np.tile(np.array(xy, np.int32), (b, 1, 1))
    radius = np.full((b, 8), r, np.int32)
    chan = np.tile(np.arange(8, dtype=np.int32), (b, 1))
    return [centers, radius, chan, np.ones((b, 8), bool)]


def splat_cases(rng, tile_h: int, tile_w: int):
    """The splat kernel's cases beyond the main path's own calls, as
    {what: (numpy inputs, C, H, W)}: dense random instances at the
    main-path shapes, then the edge cases."""
    h, w = FEAT_HW
    cases = {f"dense random, C={c}": (
        random_instances(rng, TRAIN_BATCH, n, c, h, w), c, h, w)
        for n, c in ((NUM_OBJ, 3), (NUM_OBJ * 9, 9))}
    edge = random_instances(rng, 2, 16, 3, 24, 80, radius_max=1)
    edge[1][:] = 0
    empty = random_instances(rng, 3, 20, 3, 24, 80)
    empty[3][1] = False
    return {
        **cases,
        "radius 0": (edge, 3, 24, 80),
        "one element all invalid": (empty, 3, 24, 80),
        "W=200": (random_instances(rng, 2, 12, 3, 32, 200), 3, 32, 200),
        "N=0": (random_instances(rng, 2, 0, 3, 24, 80), 3, 24, 80),
        "W=77 H=23": (random_instances(rng, 2, 20, 3, 23, 77), 3, 23, 77),
        "N=600": (random_instances(rng, 2, 600, 9, 24, 80), 9, 24, 80),
        "C=1": (random_instances(rng, 2, 12, 1, 24, 80), 1, 24, 80),
        f"boxes on {tile_h}x{tile_w} tile borders": (
            border_instances(2, tile_h, tile_w), 8, 2 * tile_h + 8,
            2 * tile_w + 32),
        "N=3000": (random_instances(rng, 2, 3000, 9, 24, 80), 9, 24, 80),
    }


def splat_bound_ms(args, c: int, h: int, w: int) -> "tuple[float, str]":
    """(least ms, what bounds it) for one splat call:
    each input read once and the map written once, against the operations
    the valid instances need on their in-map boxes."""
    centers, radius, chan, valid = (a.cpu().numpy() for a in args)
    nbytes = sum(a.nbytes for a in (centers, radius, chan, valid))
    nbytes += centers.shape[0] * c * h * w * 4
    x, y, r = centers[..., 0], centers[..., 1], radius
    cols = np.clip(x + r, -1, w - 1) - np.clip(x - r, 0, w) + 1
    rows = np.clip(y + r, -1, h - 1) - np.clip(y - r, 0, h) + 1
    pixels = int((np.maximum(cols, 0) * np.maximum(rows, 0) * valid).sum())
    ops = pixels * SPLAT_OPS_PER_PIXEL
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_environment() -> str:
    import torch

    card = gpu_name_and_power()
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[env] torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    return card


def phase_build() -> None:
    from monocon_tpu_torch.ops import splat

    t0 = time.perf_counter()
    path = splat.build()
    splat.load()
    log(f"[build] {path.name} from {splat.SOURCE.name} in "
        f"{time.perf_counter() - t0:.3f} s")


def capture_splat_inputs(batch, feat_hw, pad_hw):
    """Targets of ``batch`` on the card, and the arguments of each splat
    call they made (center heatmap, then keypoint heatmap)."""
    import torch

    from monocon_tpu_torch.ops import targets

    calls = []
    original = targets.splat_max_heatmap

    def recording(*args):
        calls.append(args)
        return original(*args)

    targets.splat_max_heatmap = recording
    try:
        with torch.no_grad():
            out = targets.generate_targets(batch["label"], feat_hw, pad_hw)
    finally:
        targets.splat_max_heatmap = original
    return out, calls


def check_splat(args, c: int, h: int, w: int, what: str):
    """The kernel against its plain version on one call's arguments;
    returns the kernel's output and the largest |difference|."""
    import torch

    from monocon_tpu_torch.ops import splat

    got = splat.splat_max_heatmap_cuda(*args, c, h, w)
    want = splat.splat_max_heatmap_plain(*args, c, h, w)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    log(f"[kernel] {what}: B={args[1].shape[0]} N={args[1].shape[1]} "
        f"C={c} {h}x{w}: max|kernel - plain| = {err:.3g}")
    if not err <= SPLAT_TOL:
        raise AssertionError(f"splat kernel disagrees on {what}: {err}")
    return got, err


def time_splat_calls(calls, what: str) -> "list[dict]":
    """Checks each of a batch's two captured splat calls (center, then
    keypoint heatmap) against the plain version and times it; one dict
    per call."""
    from monocon_tpu_torch.ops import splat

    if len(calls) != 2:
        raise AssertionError(f"{what}: expected 2 splat calls, saw "
                             f"{len(calls)}")
    shapes = []
    for name, (*args, c, h, w) in zip(("center", "keypoint"), calls):
        _, err = check_splat(args, c, h, w, f"{what}, {name} heatmap")

        def kernel():
            splat.splat_max_heatmap_cuda(*args, c, h, w)

        def plain():
            splat.splat_max_heatmap_plain(*args, c, h, w)

        bound_ms, bound_by = splat_bound_ms(args, c, h, w)
        ms = graph_ms(kernel, 50)
        shapes.append(dict(
            name=name, path=what, b=args[1].shape[0], n=args[1].shape[1],
            c=c, h=h, w=w, ms=ms, plain_ms=graph_ms(plain, 5),
            bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
            host_ms=host_ms(kernel, 200), max_abs_err=err))
        log(f"[kernel] {what}, {name}: kernel {ms:.6f} ms, plain "
            f"{shapes[-1]['plain_ms']:.6f} ms (device, CUDA graph), bound "
            f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
            f"bound; the wrapper takes {shapes[-1]['host_ms']:.6f} ms of "
            "host time per call")
    total = {k: sum(s[k] for s in shapes) for k in ("ms", "bound_ms")}
    log(f"[kernel] {what}, per train step: kernel {total['ms']:.6f} ms, "
        f"bound {total['bound_ms']:.6f} ms, "
        f"{total['bound_ms'] / total['ms']:.1%} of the bound")
    return shapes


def splat_entry(shapes, worst: float) -> dict:
    """The kernels-line entry (without ``launches``) from the two calls of
    one train step; ``worst`` is the largest |kernel - plain| seen."""
    total = {k: sum(s[k] for s in shapes)
             for k in ("ms", "plain_ms", "bound_ms")}
    return {
        "name": "splat_max_heatmap",
        "route": "cuda",
        "source": "monocon_tpu_torch/csrc/splat.cu",
        "replaces": "monocon_tpu/ops/pallas_splat.py:31",
        "max_abs_err": worst,
        # Per train step: the center and the keypoint call together.
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": total["bound_ms"],
        "bound_by": max(shapes, key=lambda s: s["bound_ms"])["bound_by"],
        "bound_share": total["bound_ms"] / total["ms"],
        "library_ms": None,
        "per_call": shapes,
    }


def phase_kernel(rng) -> "tuple[list[dict], float]":
    """The kernel against its plain version; returns the isolated train
    step's two timed calls and the largest |kernel - plain| seen."""
    import torch

    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.ops.targets import generate_targets

    # The isolated train step's own inputs: one batch's two splat calls.
    batch = train_batch(np.random.default_rng(SEED + 1), TRAIN_BATCH, PAD_HW,
                        DEVICE)
    targets_gpu, calls = capture_splat_inputs(batch, FEAT_HW, PAD_HW)
    shapes = time_splat_calls(calls, "train step")
    worst = max(s["max_abs_err"] for s in shapes)

    for what, (arrays, c, h, w) in splat_cases(rng, splat.TILE_H,
                                               splat.TILE_W).items():
        got, err = check_splat([torch.from_numpy(a).to(DEVICE)
                                for a in arrays], c, h, w, what)
        worst = max(worst, err)
        if what == "one element all invalid" and float(got[1].max()) != 0.0:
            raise AssertionError("an all-invalid element must splat nothing")
    too_many = [torch.from_numpy(a).to(DEVICE)
                for a in random_instances(rng, 1, TOO_MANY_N, 3, 24, 80)]
    try:
        splat.splat_max_heatmap_cuda(*too_many, 3, 24, 80)
    except ValueError as e:
        log(f"[kernel] N={TOO_MANY_N} is refused: {e}")
    else:
        raise AssertionError(f"N={TOO_MANY_N} must not fit the shared list")

    # Every target of the batch: card (kernel) against CPU (plain version).
    targets_cpu = generate_targets(
        {k: v.cpu() for k, v in batch["label"].items()}, FEAT_HW, PAD_HW)
    for key, want in targets_cpu.items():
        got = targets_gpu[key].cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"target {key}: {got.shape} {got.dtype} "
                                 f"against {want.shape} {want.dtype}")
        if not torch.allclose(got.double(), want.double(), rtol=1e-5,
                              atol=SPLAT_TOL):
            raise AssertionError(f"target {key} differs between card and CPU")
    log(f"[kernel] all {len(targets_cpu)} targets of a {PAD_HW[0]}x{PAD_HW[1]}"
        " batch agree, card against CPU (rtol 1e-5, atol 1e-6)")
    return shapes, worst


# (B, C, H, W, affine) of the batch-norm check: DLA-34's stem and head
# maps and its deepest level at B=8, then ragged rows, one image.
BN_SHAPES = [(8, 16, 384, 1248, True), (8, 64, 96, 312, False),
             (8, 512, 12, 39, True), (2, 3, 5, 7, True),
             (1, 32, 17, 33, False)]
# Bytes an element of a batch norm's input moves at least: x read and y
# written by the forward; grad and x read and dx written by the backward.
BN_FORWARD_BYTES, BN_BACKWARD_BYTES = 8, 12
BN_KERNELS = ("_stats", "_normalize", "_grad_sums", "_grad_input")
BN_REPS = 20


def bn_bound_ms(forward_elements: int, backward_elements: int) -> float:
    return (BN_FORWARD_BYTES * forward_elements + BN_BACKWARD_BYTES
            * backward_elements) / HBM_BYTES_PER_S * 1e3


def phase_batch_norm() -> "tuple[list[dict], float]":
    """The batch-norm kernels (``ops/batch_norm.py``) against
    ``F.batch_norm`` in training, both held to ``F.batch_norm`` in
    float64: the output, the running stats, and the gradients of the
    input, the weight and the bias may be off by at most twice the float32
    ``F.batch_norm``'s error (plus 1e-6 of the value's scale). Then a
    forward and backward of each shape timed by CUDA events (median of
    ``BN_REPS``) against its bytes bound. Returns the shapes' entries and
    the largest error."""
    import torch
    import torch.nn.functional as F

    from monocon_tpu_torch.ops import batch_norm as bn

    def kernel(x, weight, bias, mean, var):
        return bn.batch_norm_nchw(x, weight, bias, mean, var, 0.1, 1e-5)

    def plain(x, weight, bias, mean, var):
        return F.batch_norm(x, mean, var, weight, bias, True, 0.1, 1e-5)

    def step(fn, dtype, x, grad, weight, bias):
        c = x.shape[1]
        leaves = [t.to(dtype, copy=True).requires_grad_(True)
                  if t is not None else None for t in (x, weight, bias)]
        running = [torch.zeros(c, device=DEVICE, dtype=dtype),
                   torch.ones(c, device=DEVICE, dtype=dtype)]
        out = fn(*leaves, *running)
        out.backward(grad.to(dtype))
        return [out.detach(), *running] + [t.grad for t in leaves
                                           if t is not None]

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shapes, worst = [], 0.0
    for b, c, h, w, affine in BN_SHAPES:
        x = torch.randn(b, c, h, w, device=DEVICE, generator=gen) * 2 + 0.5
        grad = torch.randn(b, c, h, w, device=DEVICE, generator=gen)
        weight = (torch.rand(c, device=DEVICE, generator=gen) + 0.5
                  if affine else None)
        bias = (torch.randn(c, device=DEVICE, generator=gen)
                if affine else None)
        before = bn.launch_count
        got = step(kernel, torch.float32, x, grad, weight, bias)
        torch.cuda.synchronize()
        if bn.launch_count != before + 4:
            raise AssertionError("batch_norm_nchw must launch its four "
                                 "kernels on the card")
        f32 = step(plain, torch.float32, x, grad, weight, bias)
        f64 = step(plain, torch.float64, x, grad, weight, bias)
        errs = []
        for a, p32, want in zip(got, f32, f64):
            scale = float(want.abs().max())
            err = float((a.double() - want).abs().max())
            limit = 2 * float((p32.double() - want).abs().max()) + (
                1e-6 * scale)
            if not err <= limit:
                raise AssertionError(
                    f"batch norm {(b, c, h, w, affine)}: kernel off by "
                    f"{err:.3e} against limit {limit:.3e}")
            errs.append(err)
        times = []
        for _ in range(BN_REPS + 2):
            leaves = [t.detach().requires_grad_(True) if t is not None
                      else None for t in (x, weight, bias)]
            running = [torch.zeros(c, device=DEVICE),
                       torch.ones(c, device=DEVICE)]
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            kernel(*leaves, *running).backward(grad)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = float(np.median(times[2:]))
        bound = bn_bound_ms(x.numel(), x.numel())
        shapes.append({"shape": [b, c, h, w], "affine": affine, "ms": ms,
                       "bound_ms": bound, "bound_share": bound / ms,
                       "max_abs_err": max(errs)})
        worst = max(worst, max(errs))
        log(f"[kernel] batch norm {(b, c, h, w)} affine={affine}: max "
            f"|kernel - F.batch_norm f64| {max(errs):.3e} (output, running "
            f"stats, gradients); forward + backward {ms:.4f} ms by CUDA "
            f"events, bound {bound:.4f} ms, {bound / ms:.1%} of it")
    return shapes, worst


def bn_entry(calls: "list[dict]", worst: float, step: dict,
             launched: int) -> dict:
    """The kernels-line entry of the batch-norm kernels: the checked calls
    (``per_call``), and per step of the float32 DLA-34 train step with
    cuDNN autotuned (contiguous NCHW) its device ms and bytes bound.
    ``launched``: the kernels' launches in this process after the check;
    every one must be that step's (the other paths of this process run
    channels_last, or float32 under cuDNN's heuristics)."""
    if launched != step.get("launches"):
        raise AssertionError(
            f"the batch-norm kernels launched {launched} times after their "
            f"check, {step.get('launches')} of them in the autotuned "
            "float32 step")
    ms, bound = step.get("ms_per_step"), step.get("bound_ms_per_step")
    return {
        "name": "batch_norm_nchw",
        "route": "triton",
        "source": "monocon_tpu_torch/ops/batch_norm.py",
        "replaces": None,
        "max_abs_err": worst,
        "ms": ms,
        "bound_ms": bound,
        "bound_by": "bytes",
        "bound_share": bound / ms if ms and bound else None,
        "library_ms": None,
        "per_call": calls,
        "launches": step["launches"],
        "launches_by_path": {
            f"train_step_f32_autotuned ({step['steps']} steps)":
                step["launches"],
            "every other path of this process": launched - step["launches"]},
    }


def top30_keys(pred, b: int) -> dict:
    """(cell, class) -> (rank, heatmap peak) of each of image ``b``'s
    decoded top-30 detections."""
    from monocon_tpu_torch.ops.heatmap import local_maximum, topk_from_heatmap

    heat, inds, labels, _, _ = topk_from_heatmap(
        local_maximum(pred["center_heatmap_pred"][b:b + 1]), k=30)
    return {(int(i), int(c)): (j, float(s)) for j, (s, i, c) in
            enumerate(zip(heat[0].cpu(), inds[0].cpu(), labels[0].cpu()))}


def check_top30(got: tuple, want: tuple, b: int, heat_err: float,
                what: str) -> int:
    """The decoded top-30 of image ``b`` as sets keyed by (cell, class),
    ``got`` and ``want`` each (keys, decoded dict): a detection whose
    peak clears the 30th by more than twice the heatmaps' difference must
    be in ``got``, with the same boxes and score; the others may trade
    places with ties at the 30th. Returns the detections matched."""
    import torch

    (k_g, dec_g), (k_c, dec_c) = got, want
    kth = min(s for _, s in k_c.values())
    matched = 0
    for cell, (jc, peak) in k_c.items():
        if cell not in k_g:
            if peak - kth > 2 * heat_err:
                raise AssertionError(f"{what}: detection {cell} (peak "
                                     f"{peak}) missing")
            continue
        jg, _ = k_g[cell]
        for field in ("bboxes_2d", "bboxes_3d", "scores"):
            x, y = dec_g[field][b, jg].cpu(), dec_c[field][b, jc].cpu()
            if not torch.allclose(x, y, rtol=1e-3, atol=1e-3):
                raise AssertionError(f"{what}: {field} of {cell}: {x} vs "
                                     f"{y}")
        matched += 1
    return matched


def phase_serve() -> None:
    import torch

    from monocon_tpu_torch import create_detector, decode_predictions
    from monocon_tpu_torch.ops.decode import DEFAULT_P2

    def serve(model, image, p2):
        with torch.no_grad():
            pred = model(image)
            return pred, decode_predictions(pred, p2, PAD_HW)

    rng = np.random.default_rng(SEED + 2)
    image = rng.normal(size=(1, *PAD_HW, 3)).astype(np.float32)
    p2 = np.tile(DEFAULT_P2[None], (1, 1, 1))
    outs = {}
    for device in (DEVICE, "cpu"):
        model = create_detector(
            34, generator=torch.Generator().manual_seed(SEED),
            device=device).eval()
        pred, dec = serve(model, torch.from_numpy(image).to(device),
                          torch.from_numpy(p2).to(device))
        outs[device] = ({k: v.cpu() for k, v in pred.items()},
                        {k: v.cpu() for k, v in dec.items()},
                        top30_keys(pred, 0))
    (pred_g, dec_g, k_g), (pred_c, dec_c, k_c) = outs[DEVICE], outs["cpu"]
    for key, want in pred_c.items():
        got = pred_g[key]
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"serve: {key} has shape {got.shape} or "
                                 "non-finite values")
        err = float((got - want).abs().max())
        if err > HEAD_ATOL:
            raise AssertionError(f"serve: {key} differs card/CPU by {err}")
    heat_err = float((pred_g["center_heatmap_pred"]
                      - pred_c["center_heatmap_pred"]).abs().max())
    log(f"[serve] {len(pred_c)} head maps, card against CPU, within atol "
        f"{HEAD_ATOL}; center heatmap max|diff| {heat_err:.3g}")

    matched = check_top30((k_g, dec_g), (k_c, dec_c), 0, heat_err,
                          "serve: card against CPU")
    log(f"[serve] decoded top-30: {matched} detections matched card/CPU, "
        f"{30 - matched} differ only by ties at the 30th score")

    model = create_detector(
        34, generator=torch.Generator().manual_seed(SEED), device=DEVICE).eval()
    images = torch.from_numpy(rng.normal(
        size=(SERVE_BATCH, *PAD_HW, 3)).astype(np.float32)).to(DEVICE)
    p2s = torch.from_numpy(np.tile(DEFAULT_P2[None], (SERVE_BATCH, 1, 1))).to(DEVICE)
    for _ in range(3):
        serve(model, images, p2s)
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        _, dec = serve(model, images, p2s)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not all(torch.isfinite(v.float()).all() for v in dec.values()):
        raise AssertionError("serve: non-finite decode at batch 8")
    log(f"[serve] batch {SERVE_BATCH} at {PAD_HW[0]}x{PAD_HW[1]}, float32: "
        f"{dt / iters * 1e3:.3f} ms/batch, {SERVE_BATCH * iters / dt:.3f} "
        "frames/s")


def phase_train() -> int:
    """Returns the splat kernel's launches during the five steps."""
    import torch

    from monocon_tpu_torch import build_optimizer, create_detector, train_step
    from monocon_tpu_torch.ops import splat

    # One step at a small shape, card against CPU, from the same weights.
    small = {}
    for device in (DEVICE, "cpu"):
        model = create_detector(
            34, generator=torch.Generator().manual_seed(SEED), device=device)
        opt, sched = build_optimizer(model.parameters(), total_steps=10)
        batch = train_batch(np.random.default_rng(SEED + 3), 2, (64, 160),
                            device)
        small[device] = {k: float(v) for k, v in
                         train_step(model, opt, sched, batch).items()}
    for key, want in small["cpu"].items():
        got = small[DEVICE][key]
        if not (np.isfinite(got) and abs(got - want) <= 1e-4 + 1e-3 * abs(want)):
            raise AssertionError(f"train: {key} card {got} against CPU {want}")
    log(f"[train] one 2x64x160 step, card against CPU: all 11 losses agree "
        f"(rtol 1e-3, atol 1e-4); total {small[DEVICE]['total_loss']:.6f}")

    model = create_detector(
        34, generator=torch.Generator().manual_seed(SEED), device=DEVICE)
    opt, sched = build_optimizer(model.parameters(), total_steps=TRAIN_STEPS)
    batch = train_batch(np.random.default_rng(SEED + 1), TRAIN_BATCH, PAD_HW,
                        DEVICE)
    torch.cuda.reset_peak_memory_stats()
    splat.launch_count = 0
    times = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = train_step(model, opt, sched, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        values = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"train: non-finite loss at step {step}: "
                                 f"{values}")
        log(f"[train] step {step}: {times[-1] * 1e3:.3f} ms, total_loss "
            f"{values['total_loss']:.6f}")
    launches = splat.launch_count
    if launches != 2 * TRAIN_STEPS:
        raise AssertionError(f"train: splat kernel launched {launches} times "
                             f"in {TRAIN_STEPS} steps, expected 2 per step")
    steady = times[1:]
    log(f"[train] B={TRAIN_BATCH} at {PAD_HW[0]}x{PAD_HW[1]}, float32: "
        f"{np.mean(steady) * 1e3:.3f} ms/step over steps 1-{TRAIN_STEPS - 1} "
        f"(step 0: {times[0] * 1e3:.3f} ms); splat launches {launches}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    return launches


def check_ap(ap: dict) -> None:
    """63 ``img_bbox/KITTI/...`` and 21 ``img_bbox2d/KITTI/...`` values, all
    finite."""
    n3 = sum(k.startswith("img_bbox/KITTI/") for k in ap)
    n2 = sum(k.startswith("img_bbox2d/KITTI/") for k in ap)
    if (len(ap), n3, n2) != (84, 63, 21):
        raise AssertionError(f"eval: {len(ap)} AP keys ({n3} 3D, {n2} 2D), "
                             "expected 84 (63, 21)")
    if not all(np.isfinite(v) for v in ap.values()):
        raise AssertionError(f"eval: non-finite AP values: {ap}")


def match_annos(got: dict, want: dict, margin: float, tie: bool,
                threshold: float, what: str) -> "tuple[int, int]":
    """Pair the card's KITTI annotations of one image with the CPU's: the
    same name and every field within ``ANNO_TOL``. A detection on one side
    only is allowed when its score lies within ``margin`` of the score
    threshold, or once per side when the CPU's 30th and 31st heatmap peaks
    tie within the card/CPU difference (``tie``). Returns (matched, on
    one side only)."""
    used, matched, alone = set(), 0, {"card": 0, "CPU": 0}

    def allowed(score, side):
        if abs(float(score) - threshold) <= margin:
            return True
        alone[side] += 1
        return tie and alone[side] == 1

    for i, name in enumerate(want["name"]):
        hit = next((j for j in range(len(got["name"])) if j not in used
                    and got["name"][j] == name
                    and all(np.allclose(got[f][j], want[f][i], **ANNO_TOL)
                            for f in ANNO_FIELDS)), None)
        if hit is None:
            if not allowed(want["score"][i], "CPU"):
                raise AssertionError(
                    f"eval: {what}: CPU detection {i} ({name}, score "
                    f"{want['score'][i]}) has no match on the card")
            continue
        used.add(hit)
        matched += 1
    for j in range(len(got["name"])):
        if j not in used and not allowed(got["score"][j], "card"):
            raise AssertionError(
                f"eval: {what}: card detection {j} ({got['name'][j]}, score "
                f"{got['score'][j]}) has no match on the CPU")
    return matched, len(want["name"]) + len(got["name"]) - 2 * matched


def first_batch(loader):
    for batch in loader:
        return batch
    raise AssertionError("eval: the loader yielded no batch")


def compare_first_batch(engine, cpu_engine) -> None:
    """The first batch through the card's engine and the CPU's, from the
    same ``.pth``: the KITTI annotations, one by one."""
    import torch

    from monocon_tpu_torch.data.loader import use_on_current_stream
    from monocon_tpu_torch.engine.engine import TEST_SCORE_THRESHOLD
    from monocon_tpu_torch.ops.heatmap import local_maximum, topk_from_heatmap
    from monocon_tpu_torch.ops.image_norm import normalize_if_raw

    batch_g, batch_c = first_batch(engine.test_loader), first_batch(
        cpu_engine.test_loader)
    maps = []
    for eng, batch in ((engine, batch_g), (cpu_engine, batch_c)):
        dev = use_on_current_stream(batch)
        with torch.no_grad():
            pred = eng.model(normalize_if_raw(dev["img"], dev["img_hw"]))
        heat = pred["center_heatmap_pred"].cpu()
        # The thresholded score: peak times exp(-depth uncertainty).
        maps.append((heat, heat * torch.exp(-pred["depth_pred"][..., 1:2]).cpu()))
    (heat_g, score_g), (heat_c, score_c) = maps
    heat_err = float((heat_g - heat_c).abs().max())
    margin = 2 * float((score_g - score_c).abs().max())
    peaks = topk_from_heatmap(local_maximum(heat_c), k=31)[0]
    ties = (peaks[:, 29] - peaks[:, 30]) <= 2 * heat_err

    got, want = engine.run_eval_batch(batch_g), cpu_engine.run_eval_batch(
        batch_c)
    matched = alone = 0
    for kind in ("img_bbox", "img_bbox2d"):
        for i, (g, w) in enumerate(zip(got[kind], want[kind], strict=True)):
            m, a = match_annos(g, w, margin, bool(ties[i]),
                               TEST_SCORE_THRESHOLD, f"{kind} image {i}")
            matched += m
            alone += a
    if matched == 0:
        raise AssertionError("eval: no detection to compare in the first batch")
    log(f"[eval] first batch of {len(batch_g['p2'])}, card against CPU: "
        f"{matched} KITTI annotations matched (rtol 1e-3, atol 1e-3), "
        f"{alone} on one side only (score within {margin:.3g} of "
        f"{TEST_SCORE_THRESHOLD}, or a tie at the 30th peak); heatmap "
        f"max|diff| {heat_err:.3g}")


class LoaderWait:
    """Iterates a loader and adds up the seconds its consumer waits for
    each next batch; ``waits`` holds them one by one. Passes ``len`` and
    ``set_epoch`` on."""

    def __init__(self, loader):
        self.loader = loader
        self.seconds = 0.0
        self.waits = []

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        batches = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.waits.append(time.perf_counter() - t0)
            self.seconds += self.waits[-1]
            if batch is None:
                return
            yield batch


def traced_busy_share(fn) -> "tuple[float | None, float, int]":
    """Run ``fn()`` under torch.profiler. Returns the share of its wall time
    in which the card ran a kernel or a copy (the union of the trace's
    device intervals over the host's wall time; None when the trace holds
    no device activity), the wall seconds, and the number of device
    intervals. The tracing slows the host, so the share is a lower bound
    on the untraced run's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, covered = 0.0, float("-inf")
    for start, end in spans:
        if end > covered:
            busy_us += end - max(start, covered)
            covered = end
    share = busy_us / 1e6 / wall_s if spans else None
    return share, wall_s, len(spans)


def unpipelined_annos(engine) -> dict:
    """Every test image through the engine's model on the card with
    nothing overlapped: batches from a loader on the CPU (no pinned ring,
    no copy stream), sent with a plain ``.to``, and each batch's result
    read back with a plain ``.cpu()`` before the next is sent."""
    import torch

    from monocon_tpu_torch.data.loader import DataLoader
    from monocon_tpu_torch.engine.engine import TEST_SCORE_THRESHOLD
    from monocon_tpu_torch.ops.decode import decode_predictions
    from monocon_tpu_torch.ops.image_norm import normalize_if_raw
    from monocon_tpu_torch.utils.convert import (
        convert_to_kitti_2d,
        convert_to_kitti_3d,
        split_batch_detections,
    )

    timed = engine.test_loader
    loader = DataLoader(engine.test_dataset, "cpu",
                        batch_size=timed.batch_size, shuffle=False,
                        num_workers=timed.num_workers, pad_hw=timed.pad_hw)
    out = {"img_bbox": [], "img_bbox2d": []}
    for batch in loader:
        with torch.no_grad():
            image = normalize_if_raw(batch["img"].to(engine.device),
                                     batch["img_hw"].to(engine.device))
            decoded = decode_predictions(
                engine.model(image), batch["p2"].to(engine.device),
                (image.shape[1], image.shape[2]))
        per_image = split_batch_detections(
            {k: v.cpu().numpy() for k, v in decoded.items()},
            TEST_SCORE_THRESHOLD)
        out["img_bbox"] += convert_to_kitti_3d(
            per_image, batch["img_metas"], batch["calib"])
        out["img_bbox2d"] += convert_to_kitti_2d(per_image,
                                                 batch["img_metas"])
    return out


def check_same_annos(got: dict, want: dict) -> "tuple[int, float]":
    """The timed loop's KITTI annotations against the unpipelined run's,
    image by image: the same images in the same order, the same names,
    every field within ``PIPELINE_TOL``. Returns (annotations compared,
    the largest absolute difference)."""
    count, worst = 0, 0.0
    for kind in ("img_bbox", "img_bbox2d"):
        if len(got[kind]) != len(want[kind]):
            raise AssertionError(
                f"eval: {kind}: {len(got[kind])} images from the timed loop, "
                f"{len(want[kind])} unpipelined")
        for i, (g, w) in enumerate(zip(got[kind], want[kind])):
            if (list(g["name"]) != list(w["name"])
                    or not np.array_equal(g["sample_idx"], w["sample_idx"])):
                raise AssertionError(
                    f"eval: {kind} image {i}: the timed loop gave "
                    f"{list(g['name'])} for samples {g['sample_idx']}, the "
                    f"unpipelined run {list(w['name'])} for {w['sample_idx']}")
            for f in ANNO_FIELDS:
                if not np.allclose(g[f], w[f], **PIPELINE_TOL):
                    raise AssertionError(
                        f"eval: {kind} image {i} {f}: the timed loop gave "
                        f"{g[f]}, the unpipelined run {w[f]}")
                if len(w[f]):
                    worst = max(worst, float(np.max(np.abs(
                        np.asarray(g[f], np.float64) - w[f]))))
            count += len(w["name"])
    return count, worst


def phase_eval(tmp: Path) -> None:
    import torch

    from monocon_tpu_torch import create_detector
    from monocon_tpu_torch.config import get_default_cfg
    from monocon_tpu_torch.data.loader import use_on_current_stream
    from monocon_tpu_torch.data.png import read_png
    from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
    from monocon_tpu_torch.engine.engine import EVAL_CLASSES, MonoConEngine
    from monocon_tpu_torch.ops import splat

    root = tmp / "kitti"
    t0 = time.perf_counter()
    generate_kitti_dataset(str(root), num_train=0, num_val=EVAL_IMAGES,
                           image_hw=EVAL_IMAGE_HW, seed=SEED)
    log(f"[eval] wrote {EVAL_IMAGES} synthetic val images at "
        f"{EVAL_IMAGE_HW[0]}x{EVAL_IMAGE_HW[1]} in "
        f"{time.perf_counter() - t0:.3f} s")

    model = create_detector(34, generator=torch.Generator().manual_seed(SEED),
                            device="cpu")
    with torch.no_grad():
        model.head.heatmap_head[3].bias.fill_(HEATMAP_BIAS)
    pth = tmp / "model.pth"
    torch.save({"state_dict": {"model": model.state_dict()}}, pth)
    cfg = get_default_cfg()
    cfg.DATA.ROOT = str(root)
    engine = MonoConEngine(cfg, is_test=True, autotune=False)
    engine.load_checkpoint(str(pth))
    log(f"[eval] MonoConEngine on {engine.device}: batch "
        f"{cfg.DATA.BATCH_SIZE}, canvas {cfg.TPU.PAD_HW}, "
        f"{cfg.TPU.COMPUTE_DTYPE}, {cfg.TPU.IMAGE_TRANSPORT} transport, "
        f"{cfg.DATA.NUM_WORKERS} loader threads")

    splat.launch_count = 0
    check_ap(engine.evaluate(verbose=False))   # warm-up
    paths = [engine.test_dataset.image_path(i) for i in range(DECODE_FILES)]
    t0 = time.perf_counter()
    for path in paths:
        read_png(path)
    decode_ms = (time.perf_counter() - t0) / len(paths) * 1e3

    t0 = time.perf_counter()
    images = 0
    for batch in engine.test_loader:
        use_on_current_stream(batch)
        images += len(batch["p2"])
    torch.cuda.synchronize()
    loader_ips = images / (time.perf_counter() - t0)

    device_ms = []
    loader = engine.test_loader
    engine.test_loader = waited = LoaderWait(loader)
    t0 = time.perf_counter()
    container = engine.collect_detections(device_ms)
    collect_s = time.perf_counter() - t0
    engine.test_loader = loader
    t0 = time.perf_counter()
    ap = engine.test_dataset.evaluate(container, eval_classes=EVAL_CLASSES,
                                      verbose=False)
    ap_s = time.perf_counter() - t0
    check_ap(ap)
    if splat.launch_count:
        raise AssertionError("eval: the splat kernel ran on the eval path")
    with_dets = sum(len(a["name"]) > 0 for a in container["img_bbox"])
    if len(container["img_bbox"]) != EVAL_IMAGES or with_dets == 0:
        raise AssertionError(f"eval: {len(container['img_bbox'])} images, "
                             f"{with_dets} with a detection")
    log(f"[eval] AP dict: 84 keys, all finite; {with_dets} of {EVAL_IMAGES} "
        f"images have a 3D detection; Car 3D AP40 moderate (strict) "
        f"{ap['img_bbox/KITTI/Car_3D_AP40_moderate_strict']}")
    log(f"[eval] PNG decode: {decode_ms:.3f} ms per image (one thread, "
        f"{len(paths)} files)")
    log(f"[eval] loader alone (decode, collate, pinned H2D): "
        f"{loader_ips:.3f} images/s")
    log(f"[eval] collect loop (loader, H2D, forward, decode, D2H, "
        f"conversion): {EVAL_IMAGES / collect_s:.3f} frames/s, "
        f"{collect_s:.3f} s for {EVAL_IMAGES} images")
    log(f"[eval] collect loop waited {waited.seconds:.3f} s "
        f"({waited.seconds / collect_s:.1%} of it) for the loader's next "
        "batch")
    log(f"[eval] AP stage: {ap_s:.3f} s")
    log(f"[eval] forward+decode event span share "
        f"{sum(device_ms) / 1e3 / collect_s:.1%} of the collect loop's wall "
        f"time ({sum(device_ms):.3f} ms over {len(device_ms)} batches, CUDA "
        "events; an upper bound on the card's busy share, since a span "
        "also holds the card's waits for launches)")

    compared, worst = check_same_annos(container, unpipelined_annos(engine))
    log(f"[eval] timed collect loop against the unpipelined run, all "
        f"{len(container['img_bbox'])} images: {compared} KITTI annotations "
        f"equal within rtol 1e-6 / atol 1e-6, max |diff| {worst:.3g}")

    share, traced_s, spans = traced_busy_share(engine.collect_detections)
    busy = "not measured (no device activity in the trace)" if share is None \
        else f"{share:.1%}"
    log(f"[eval] card busy share from a torch.profiler trace of the collect "
        f"loop: {busy} ({spans} device intervals, {traced_s:.3f} s traced "
        "wall; a lower bound, the tracing slows the host)")

    cpu_engine = MonoConEngine(cfg, is_test=True, device="cpu")
    cpu_engine.load_checkpoint(str(pth))
    compare_first_batch(engine, cpu_engine)


class FirstSteps:
    """A train loader cut after its first ``n`` batches: a run that stops
    right after the checkpoint of step ``n``."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        batches = iter(self.loader)
        for _ in range(self.n):
            yield next(batches)


def loop_cfg(root: Path, out: Path, seed: int):
    """The configuration of the train-loop runs: the defaults (DLA-34,
    batch 8, 384x1248 canvas, 320x960 crops, augmentation, uint8
    transport) with one epoch, a checkpoint every LOOP_CKPT_STEPS steps,
    an evaluation after each epoch and a progress line every 4 steps."""
    from monocon_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.DATA.ROOT = str(root)
    cfg.OUTPUT_DIR = str(out)
    cfg.SEED = seed
    cfg.SOLVER.OPTIM.NUM_EPOCHS = 1
    cfg.PERIOD.CKPT_PERIOD_STEPS = LOOP_CKPT_STEPS
    cfg.PERIOD.EVAL_PERIOD = 1
    cfg.PERIOD.LOG_PERIOD = 4
    return cfg


def run_train_cli(root: Path, out: Path) -> str:
    """Run A: the train CLI in a subprocess on the card, deterministic,
    with the settings of :func:`loop_cfg`. Returns its standard output."""
    cmd = [sys.executable, "-m", "monocon_tpu_torch.train",
           "--data_root", str(root), "--output_dir", str(out),
           "--num_epochs", "1", "--deterministic", "--set", "SEED", "0",
           "--set", "PERIOD.CKPT_PERIOD_STEPS", str(LOOP_CKPT_STEPS),
           "--set", "PERIOD.EVAL_PERIOD", "1",
           "--set", "PERIOD.LOG_PERIOD", "4"]
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True,
                          timeout=TRAIN_CLI_TIMEOUT_S)
    (out / "train_cli.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"loop: the train CLI exited {proc.returncode}:"
                             f"\n{proc.stderr[-3000:]}")
    return proc.stdout


def read_run(out: Path) -> "tuple[dict, dict, dict]":
    """The final checkpoint of the run in ``out``: its ``state.pth``
    container, its ``meta.json``, and the AP dict of its last evaluation
    (from ``tf_logs/metrics.jsonl``)."""
    import torch

    final = out / "checkpoints" / "epoch_001_final"
    container = torch.load(final / "state.pth", map_location="cpu",
                           weights_only=True)
    meta = json.loads((final / "meta.json").read_text())
    evals = [json.loads(line) for line in
             (out / "tf_logs" / "metrics.jsonl").read_text().splitlines()]
    evals = [e for e in evals if e["tag"] == "eval"]
    if not evals:
        raise AssertionError(f"loop: no evaluation logged in {out}")
    ap = {k: v for k, v in evals[-1].items() if k not in ("step", "tag")}
    return container, meta, ap


def tensors_differing(a, b, path="") -> "list[str]":
    """The paths at which two nests of dicts, lists and tensors differ
    (tensors bit for bit)."""
    import torch

    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict):
        if not isinstance(b, dict) or a.keys() != b.keys():
            return [path]
        return [p for k in a for p in tensors_differing(a[k], b[k],
                                                         f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [path]
        return [p for i, (x, y) in enumerate(zip(a, b))
                for p in tensors_differing(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def check_losses(losses, what: str) -> None:
    if not losses or not all(np.isfinite(v) for v in losses):
        raise AssertionError(f"loop: {what}: non-finite or no losses: "
                             f"{losses}")


def count_launches(fn, steps: int, what: str) -> int:
    """Run ``fn()`` with the splat kernel's count set to 0; it must launch
    twice per train step. Returns the launches."""
    from monocon_tpu_torch.ops import splat

    splat.launch_count = 0
    fn()
    launches = splat.launch_count
    if launches != 2 * steps:
        raise AssertionError(f"loop: {what}: the splat kernel launched "
                             f"{launches} times in {steps} steps, expected "
                             "2 per step")
    return launches


def phase_train_loop(tmp: Path) -> "tuple[list[dict], dict]":
    """Runs A-D (see the module docstring). Returns the two timed splat
    calls of one loop batch, and the splat launches of runs B-D."""
    import torch

    from monocon_tpu_torch import MonoConEngine
    from monocon_tpu_torch.data.loader import use_on_current_stream
    from monocon_tpu_torch.data.png import read_png
    from monocon_tpu_torch.data.synthetic import generate_kitti_dataset
    from monocon_tpu_torch.data.transforms import PhotometricDistortion
    from monocon_tpu_torch.engine.train_step import FEAT_STRIDE

    root = tmp / "kitti_train"
    t0 = time.perf_counter()
    generate_kitti_dataset(str(root), num_train=LOOP_TRAIN_IMAGES,
                           num_val=LOOP_VAL_IMAGES, image_hw=EVAL_IMAGE_HW,
                           seed=SEED + 4)
    log(f"[loop] wrote {LOOP_TRAIN_IMAGES} train and {LOOP_VAL_IMAGES} val "
        f"synthetic images at {EVAL_IMAGE_HW[0]}x{EVAL_IMAGE_HW[1]} in "
        f"{time.perf_counter() - t0:.3f} s")

    out_a, out_b, out_d = tmp / "run_a", tmp / "run_b", tmp / "run_d"
    t0 = time.perf_counter()
    stdout = run_train_cli(root, out_a)
    log(f"[loop] A: python -m monocon_tpu_torch.train --deterministic, one "
        f"epoch of {LOOP_STEPS} steps with an evaluation, in "
        f"{time.perf_counter() - t0:.3f} s (subprocess wall)")
    for line in stdout.splitlines():
        if line.startswith(("| Progress", "- Epoch Time")):
            log(f"[loop] A: {line.strip()}")

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        engine_b = MonoConEngine(loop_cfg(root, out_b, SEED), autotune=False)
        engine_b.train_loader = FirstSteps(engine_b.train_loader,
                                           LOOP_CKPT_STEPS)
        launches_b = count_launches(engine_b.train_one_epoch,
                                    LOOP_CKPT_STEPS, "B")
        check_losses(engine_b.entire_losses, "B")
        del engine_b
        engine_c = MonoConEngine(loop_cfg(root, out_b, LOOP_RESUME_SEED),
                                 autotune=False)
        if (engine_c.epochs, engine_c._resume_step_in_epoch,
                engine_c.cfg.SEED) != (1, LOOP_CKPT_STEPS, SEED):
            raise AssertionError(
                f"loop: C resumed at epoch {engine_c.epochs}, step "
                f"{engine_c._resume_step_in_epoch}, seed {engine_c.cfg.SEED}")
        launches_c = count_launches(engine_c.train,
                                    LOOP_STEPS - LOOP_CKPT_STEPS, "C")
        del engine_c
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False

    (state_a, meta_a, ap_a), (state_c, meta_c, ap_c) = (read_run(out_a),
                                                        read_run(out_b))
    for ap in (ap_a, ap_c):
        check_ap(ap)
    check_losses(meta_a["entire_losses"], "A")
    check_losses(meta_c["entire_losses"], "C")
    differ = tensors_differing(state_c, state_a)
    if differ:
        raise AssertionError(f"loop: C's state.pth differs from A's at "
                             f"{differ[:10]} ({len(differ)} entries)")
    for key in ("entire_losses", "global_iters", "epoch", "seed",
                "step_in_epoch"):
        if meta_c[key] != meta_a[key]:
            raise AssertionError(f"loop: meta.json {key}: C {meta_c[key]} "
                                 f"against A {meta_a[key]}")
    n_tensors = len(state_a["state_dict"]["model"]) + sum(
        len(v) for v in state_a["state_dict"]["optimizer"]["state"].values())
    log(f"[loop] C (resumed from B's step-{LOOP_CKPT_STEPS} checkpoint with "
        f"SEED {LOOP_RESUME_SEED}, adopted {SEED}) equals A bit for bit: "
        f"{n_tensors} tensors of weights, BN state and AdamW state, the "
        f"schedule count {state_a['state_dict']['scheduler']['count']}, and "
        f"the loss history of {len(meta_a['entire_losses'])} steps "
        f"(last {meta_a['entire_losses'][-1]:.6f}); splat launches B "
        f"{launches_b}, C {launches_c}; both evaluations 84 finite AP keys")
    del state_a, state_c
    gc.collect()
    torch.cuda.empty_cache()

    # D: the loop as training runs it, with the default algorithms.
    cfg = loop_cfg(root, out_d, SEED)
    cfg.SOLVER.OPTIM.NUM_EPOCHS = LOOP_TIMED_EPOCHS
    cfg.PERIOD.CKPT_PERIOD_STEPS = 0
    cfg.PERIOD.EVAL_PERIOD = -1
    cfg.PERIOD.LOG_PERIOD = LOOP_STEPS
    engine = MonoConEngine(cfg, autotune=False)
    engine.train_loader = waited = LoaderWait(engine.train_loader)
    torch.cuda.reset_peak_memory_stats()
    launches_d = count_launches(engine.train, LOOP_TIMED_EPOCHS * LOOP_STEPS,
                                "D")
    peak = torch.cuda.max_memory_allocated()
    check_losses(engine.entire_losses, "D")
    # Epoch 2 from the arrival of its first batch to the end of its last
    # step (train_one_epoch reads the losses back: a synchronise).
    epoch2_waits = waited.waits[LOOP_STEPS + 1:]
    first_wait, waits = epoch2_waits[0], epoch2_waits[1:LOOP_STEPS]
    loop_s = engine.epoch_times[1] - first_wait
    log(f"[loop] D: MonoConEngine.train(), {LOOP_TIMED_EPOCHS} epochs of "
        f"{LOOP_STEPS} steps, B={TRAIN_BATCH}, default algorithms: epoch 2 "
        f"{loop_s * 1e3 / LOOP_STEPS:.3f} ms/step, "
        f"{LOOP_TRAIN_IMAGES / loop_s:.3f} images/s (host clock from its "
        f"first batch's arrival to the end of its last step; its first "
        f"batch took {first_wait:.3f} s to come); epoch 1 (cuDNN's first "
        f"calls) {engine.epoch_times[0]:.3f} s; splat launches {launches_d}")
    log(f"[loop] D: epoch 2 waited {sum(waits):.3f} s for the loader's "
        f"batches 2-{LOOP_STEPS} ({sum(waits) / loop_s:.1%} of its loop; "
        f"longest {max(waits):.3f} s)")
    log(f"[loop] D: max_memory_allocated {peak} bytes")
    t0 = time.perf_counter()
    path = Path(engine.save_checkpoint())
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    log(f"[loop] checkpoint save: {save_s:.3f} s, {nbytes} bytes "
        "(state.pth and meta.json, written and synced)")

    loader = waited.loader
    loader.set_epoch(LOOP_TIMED_EPOCHS + 1)
    first = None
    t0 = time.perf_counter()
    for batch in loader:
        dev = use_on_current_stream(batch)
        if first is None:
            first = dev
    torch.cuda.synchronize()
    log(f"[loop] augmented train loader alone ({loader.num_workers} "
        f"threads: decode, augmentation, collate, pinned H2D): "
        f"{LOOP_TRAIN_IMAGES / (time.perf_counter() - t0):.3f} images/s "
        f"(the loop above consumed {LOOP_TRAIN_IMAGES / loop_s:.3f})")

    # The kernel on the loop's own inputs: one augmented batch's two
    # splat calls, on the canvas the loop trains on.
    pad_hw = tuple(first["img"].shape[1:3])
    feat_hw = (pad_hw[0] // FEAT_STRIDE, pad_hw[1] // FEAT_STRIDE)
    _, calls = capture_splat_inputs(first, feat_hw, pad_hw)
    shapes = time_splat_calls(calls, "train loop")
    del first, dev

    decoded = [read_png(engine.train_dataset.image_path(i))
               for i in range(PHOTOMETRIC_IMAGES)]
    distort = PhotometricDistortion()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    for img in decoded:
        distort({"img": img}, rng)
    log(f"[loop] PhotometricDistortion: "
        f"{(time.perf_counter() - t0) / len(decoded) * 1e3:.3f} ms per "
        f"{EVAL_IMAGE_HW[0]}x{EVAL_IMAGE_HW[1]} image (one thread, "
        f"{len(decoded)} images)")
    return shapes, {"train_loop_B": launches_b, "train_loop_C": launches_c,
                    "train_loop_D": launches_d}


def check_bf16(got, want, ref_f32, what: str) -> "tuple[float, float]":
    """``max|got - want| <= max(BF16_FACTOR * max|want - ref_f32|, BF16_EPS *
    max|ref_f32|)``: a card's bfloat16 value against the CPU's, bounded by
    the CPU's own bfloat16-to-float32 gap. Returns (error, gap)."""
    got, want, ref_f32 = (np.asarray(a, np.float64)
                          for a in (got, want, ref_f32))
    gap = float(np.abs(want - ref_f32).max())
    err = float(np.abs(got - want).max())
    bound = max(BF16_FACTOR * gap, BF16_EPS * float(np.abs(ref_f32).max()))
    if not err <= bound:
        raise AssertionError(f"configs: {what}: card against CPU {err:.3g}, "
                             f"above {bound:.3g} (CPU bf16 gap {gap:.3g})")
    return err, gap


def make_detector(num_layers: int, device, dtype, seed: int,
                  memory_format=None):
    """``create_detector`` with weights from ``seed``. DLA-102's random init
    carries its eval-mode activations to about 1e5 through the residual
    roots, and the 3D decode overflows; so its BN running stats are set to
    those of one batch (noise at 64x160, a train-mode forward on the CPU
    with momentum 1), as a trained model's would follow its activations."""
    import torch

    from monocon_tpu_torch import create_detector

    model = create_detector(num_layers,
                            generator=torch.Generator().manual_seed(seed),
                            device=device, compute_dtype=dtype,
                            memory_format=(memory_format
                                           or torch.channels_last))
    if num_layers != 102:
        return model
    cpu = create_detector(num_layers,
                          generator=torch.Generator().manual_seed(seed),
                          device="cpu")
    for m in cpu.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    noise = np.random.default_rng(seed).normal(size=(2, *SMALL_HW, 3))
    with torch.no_grad():
        cpu.train()(torch.from_numpy(noise.astype(np.float32)))
    model.load_state_dict(cpu.state_dict())
    return model


def small_runs(num_layers: int, dtypes, seed: int):
    """One eval forward of an image and one train step of a batch of 2 at
    64x160, per (device, dtype), from the same weights: {(device, dtype):
    (head maps, losses)}, on the host."""
    import torch

    from monocon_tpu_torch import build_optimizer, train_step

    rng = np.random.default_rng(seed)
    image = rng.normal(size=(1, *SMALL_HW, 3)).astype(np.float32)
    out = {}
    for device in (DEVICE, "cpu"):
        for dtype in dtypes:
            model = make_detector(num_layers, device, dtype, seed).eval()
            with torch.no_grad():
                maps = {k: v.cpu() for k, v in
                        model(torch.from_numpy(image).to(device)).items()}
            opt, solver = build_optimizer(model.parameters(), total_steps=10)
            batch = train_batch(np.random.default_rng(seed + 1), 2, SMALL_HW,
                                device)
            losses = {k: float(v) for k, v in
                      train_step(model, opt, solver, batch).items()}
            out[device, dtype] = (maps, losses)
    return out


def serve_fps(num_layers: int, dtype, seed: int) -> float:
    """Frames/s of the eval forward + 3D decode at batch 8, 384x1280."""
    import torch

    from monocon_tpu_torch import decode_predictions
    from monocon_tpu_torch.ops.decode import DEFAULT_P2

    model = make_detector(num_layers, DEVICE, dtype, seed).eval()
    images = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(SERVE_BATCH, *PAD_HW, 3)).astype(np.float32)).to(DEVICE)
    p2s = torch.from_numpy(np.tile(DEFAULT_P2[None],
                                   (SERVE_BATCH, 1, 1))).to(DEVICE)

    def serve():
        with torch.no_grad():
            return decode_predictions(model(images), p2s, PAD_HW)

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        dec = serve()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not all(torch.isfinite(v.float()).all() for v in dec.values()):
        raise AssertionError(f"configs: DLA-{num_layers} {dtype}: non-finite "
                             "decode")
    return SERVE_BATCH * iters / dt


def kernel_breakdown(fn, top: int = 6,
                     by_name: "dict | None" = None) -> str:
    """One ``fn()`` under torch.profiler: the card's busy share of its wall
    time, its kernels' summed device time, and the ``top`` kernels by
    device time (a lower bound on the untraced busy share: tracing slows
    the host). ``by_name``, where given, receives each kernel's (launches,
    device us)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {} if by_name is None else by_name
    spans = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            start, end = e.time_range.start, e.time_range.end
            spans.append((start, end))
            count, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (count + 1, us + end - start)
    if not spans:
        return "not measured (no device activity in the trace)"
    busy_us, covered = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > covered:
            busy_us += end - max(start, covered)
            covered = end
    total_us = sum(us for _, us in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return (f"busy {busy_us / 1e3 / wall_ms:.1%} of {wall_ms:.3f} ms traced "
            f"wall, kernels {total_us / 1e3:.3f} ms in {len(spans)} launches;"
            " top: " + "; ".join(f"{name[:70]} {us / 1e3:.3f} ms x{count}"
                                for name, (count, us) in ranked))


def timed_steps(num_layers: int, dtype, batch_size: int, seed: int,
                what: str, breakdown: bool = False,
                bn_step: "dict | None" = None) -> "tuple[float, int, int]":
    """``TRAIN_STEPS`` train steps at 384x1280 with uint8 images, the
    splat kernel's count set to 0 before them: (mean ms over steps 1 on,
    max_memory_allocated, launches). Two launches per step, and every loss
    finite. The detector takes the memory format of this process's cuDNN
    setting (``conv_memory_format``); in contiguous NCHW every call of a
    train-mode BatchNorm2d (not the attention's MomentsBatchNorm) launches
    the batch-norm kernels twice, and its backward, where the loss reaches
    it, twice more; in channels_last none. ``breakdown``: then one more
    step under torch.profiler. ``bn_step``, where given, receives the
    batch-norm kernels' launches over every step, and with ``breakdown``
    their device ms and bytes bound in the profiled step."""
    import torch

    from monocon_tpu_torch import build_optimizer, train_step
    from monocon_tpu_torch.models.detector import conv_memory_format
    from monocon_tpu_torch.models.layers import BatchNorm2d, MomentsBatchNorm
    from monocon_tpu_torch.ops import batch_norm as bn
    from monocon_tpu_torch.ops import splat

    gc.collect()
    torch.cuda.empty_cache()
    model = make_detector(num_layers, DEVICE, dtype, seed, conv_memory_format(
        DEVICE, dtype, torch.backends.cudnn.benchmark))
    norms = [m for m in model.modules() if isinstance(m, BatchNorm2d)
             and not isinstance(m, MomentsBatchNorm)]
    calls = dict.fromkeys(("forward", "backward", "forward_elements",
                           "backward_elements"), 0)

    def on_backward(grad):
        calls["backward"] += 1
        calls["backward_elements"] += grad.numel()

    def on_forward(module, args, out):
        calls["forward"] += 1
        calls["forward_elements"] += out.numel()
        if out.requires_grad:
            out.register_hook(on_backward)

    seen = [m.register_forward_hook(on_forward) for m in norms]
    opt, solver = build_optimizer(model.parameters(), total_steps=TRAIN_STEPS)
    batch = train_batch(np.random.default_rng(seed + 1), batch_size, PAD_HW,
                        DEVICE)
    torch.cuda.reset_peak_memory_stats()
    splat.launch_count = 0
    bn_before = bn.launch_count
    times = []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses = train_step(model, opt, solver, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not all(np.isfinite(float(v)) for v in losses.values()):
            raise AssertionError(f"configs: {what}: non-finite loss at step "
                                 f"{step}")
    launches = splat.launch_count
    if launches != 2 * TRAIN_STEPS:
        raise AssertionError(f"configs: {what}: splat launched {launches} "
                             f"times in {TRAIN_STEPS} steps")
    nchw = model.memory_format == torch.contiguous_format
    bn_launches = bn.launch_count - bn_before
    if (calls["forward"] != len(norms) * TRAIN_STEPS or bn_launches != (
            2 * calls["forward"] + 2 * calls["backward"] if nchw else 0)):
        raise AssertionError(
            f"configs: {what}: the batch-norm kernels launched {bn_launches} "
            f"times in {TRAIN_STEPS} steps of a {model.memory_format} model "
            f"with {len(norms)} batch norms: {calls['forward']} calls, "
            f"{calls['backward']} backward")
    peak = torch.cuda.max_memory_allocated()
    ms = float(np.mean(times[1:])) * 1e3
    cudnn = ("cuDNN autotuned" if torch.backends.cudnn.benchmark
             else "cuDNN heuristics")
    log(f"[configs] {what}: B={batch_size} at {PAD_HW[0]}x{PAD_HW[1]}, uint8 "
        f"images, {cudnn}: {ms:.3f} ms/step over steps 1-{TRAIN_STEPS - 1} "
        f"({', '.join(f'{t * 1e3:.3f}' for t in times[1:])}; step 0: "
        f"{times[0] * 1e3:.3f} ms), {batch_size * 1e3 / ms:.3f} images/s; "
        f"max_memory_allocated {peak} bytes; splat launches {launches}; "
        f"{model.memory_format}, batch-norm kernel launches {bn_launches} "
        f"({calls['forward']} calls, {calls['backward']} backward)")
    if breakdown:
        kernels, before = {}, dict(calls)
        log(f"[configs] {what}: one more B={batch_size} step under "
            "torch.profiler: " + kernel_breakdown(
                lambda: train_step(model, opt, solver, batch),
                by_name=kernels))
        if bn_step is not None and nchw:
            bn_step.update(
                ms_per_step=sum(us for name, (_, us) in kernels.items()
                                if name.startswith(BN_KERNELS)) / 1e3,
                bound_ms_per_step=bn_bound_ms(*(
                    calls[k] - before[k] for k in ("forward_elements",
                                                   "backward_elements"))))
    for h in seen:
        h.remove()
    if bn_step is not None:
        bn_step.update(launches=bn.launch_count - bn_before,
                       steps=TRAIN_STEPS + breakdown,
                       memory_format=str(model.memory_format))
    del model, opt, solver, batch
    gc.collect()
    torch.cuda.empty_cache()
    return ms, peak, launches


def phase_bf16() -> "tuple[int, float, dict]":
    """bfloat16 DLA-34: serving and the train step, card against CPU at
    64x160, then timed at 384x1280. Returns the splat launches of the
    timed steps, the B=16 ms/step with cuDNN autotuned (as the train
    CLI runs the shipped config), and the batch-norm kernels' record of
    the float32 step with cuDNN autotuned (contiguous NCHW)."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    runs = small_runs(34, (bf16, f32), SEED + 5)
    (maps_g, losses_g) = runs[DEVICE, bf16]
    (maps_c, losses_c), (maps_f, losses_f) = runs["cpu", bf16], runs["cpu", f32]
    ratios = []
    for key in maps_c:
        if not torch.isfinite(maps_g[key]).all():
            raise AssertionError(f"configs: bf16 serve {key} not finite")
        err, gap = check_bf16(maps_g[key], maps_c[key], maps_f[key],
                              f"bf16 serve {key}")
        ratios.append(err / gap if gap else 0.0)
    log(f"[configs] bf16 DLA-34, one 64x160 image, card against CPU: all "
        f"{len(maps_c)} head maps within max({BF16_FACTOR:g} x the CPU's "
        f"bf16-f32 gap, bf16 eps x scale); |card - CPU| / gap "
        f"{min(ratios):.3f}-{max(ratios):.3f}")
    for key in losses_c:
        check_bf16(losses_g[key], losses_c[key], losses_f[key],
                   f"bf16 train {key}")
    log(f"[configs] bf16 DLA-34, one 2x64x160 step, card against CPU: all "
        f"{len(losses_c)} losses within the same bound; total "
        f"{losses_g['total_loss']:.6f} (CPU bf16 {losses_c['total_loss']:.6f},"
        f" f32 {losses_f['total_loss']:.6f})")
    log(f"[configs] bf16 DLA-34 serve: batch {SERVE_BATCH} at "
        f"{PAD_HW[0]}x{PAD_HW[1]}: {serve_fps(34, bf16, SEED):.3f} frames/s")
    # As chip_smoke's other phases run (cuDNN's heuristics), then as the
    # train CLI runs (USE_BENCHMARK: cuDNN autotunes); float32 beside it in
    # the same call, with where the card's time goes in one step of each.
    launches, bn_step = 0, {}
    for benchmark in (False, True):
        torch.backends.cudnn.benchmark = benchmark
        try:
            for batch_size in (TRAIN_BATCH, BIG_BATCH):
                ms, _, count = timed_steps(
                    34, bf16, batch_size, SEED, "bf16 DLA-34 train",
                    breakdown=batch_size == TRAIN_BATCH)
                launches += count
            timed_steps(34, f32, TRAIN_BATCH, SEED, "float32 DLA-34 train",
                        breakdown=True, bn_step=bn_step if benchmark else None)
        finally:
            torch.backends.cudnn.benchmark = False
    return launches, ms, bn_step


def phase_dla102() -> int:
    """DLA-102 (Bottlenecks, residual roots) in float32 and bfloat16: card
    against CPU at 64x160, serve frames/s and train ms/step at 384x1280,
    batch 8 (halved if the card's memory refuses it). Returns the splat
    launches of the timed steps."""
    import torch

    bf16, f32 = torch.bfloat16, torch.float32
    runs = small_runs(102, (f32, bf16), SEED + 6)
    (maps_g, losses_g), (maps_c, losses_c) = runs[DEVICE, f32], runs["cpu", f32]
    worst = 0.0
    for key, want in maps_c.items():
        got = maps_g[key]
        if not torch.isfinite(got).all():
            raise AssertionError(f"configs: DLA-102 serve {key} not finite")
        rel = float((got - want).abs().max() / want.abs().max())
        if rel > DLA102_REL:
            raise AssertionError(f"configs: DLA-102 f32 serve {key}: card "
                                 f"against CPU {rel:.3g} of its scale")
        worst = max(worst, rel)
    for key, want in losses_c.items():
        got = losses_g[key]
        if not (np.isfinite(got) and abs(got - want) <= 1e-4 + 1e-3 * abs(want)):
            raise AssertionError(f"configs: DLA-102 f32 train {key}: card "
                                 f"{got} against CPU {want}")
    (maps_gb, losses_gb), (maps_cb, losses_cb) = (runs[DEVICE, bf16],
                                                  runs["cpu", bf16])
    for key in maps_cb:
        check_bf16(maps_gb[key], maps_cb[key], maps_c[key],
                   f"DLA-102 bf16 serve {key}")
    for key in losses_cb:
        check_bf16(losses_gb[key], losses_cb[key], losses_c[key],
                   f"DLA-102 bf16 train {key}")
    log(f"[configs] DLA-102 at 64x160, card against CPU: float32 head maps "
        f"within {DLA102_REL:g} of each map's scale (worst {worst:.3g}) and "
        f"the 11 losses within rtol 1e-3 / atol 1e-4; bfloat16 maps and "
        f"losses within the bf16 bound")
    launches = 0
    for dtype in (f32, bf16):
        name = "float32" if dtype == f32 else "bfloat16"
        log(f"[configs] DLA-102 {name} serve: batch {SERVE_BATCH} at "
            f"{PAD_HW[0]}x{PAD_HW[1]}: {serve_fps(102, dtype, SEED):.3f} "
            "frames/s")
        batch_size = TRAIN_BATCH
        while True:
            try:
                launches += timed_steps(102, dtype, batch_size, SEED,
                                        f"DLA-102 {name} train")[2]
                break
            except torch.cuda.OutOfMemoryError:
                if batch_size == 1:
                    raise
                gc.collect()
                torch.cuda.empty_cache()
                log(f"[configs] DLA-102 {name} train: B={batch_size} does "
                    f"not fit the card's memory; halving the batch")
                batch_size //= 2
    return launches


def phase_config_file(root: Path, out: Path) -> int:
    """The shipped config through the train CLI in a subprocess, with
    PyYAML, OpenCV and PIL refused: bfloat16, batch 16, two micro-steps per
    optimizer step, one epoch of the train-loop phase's 64 images and an
    evaluation of its 16. Returns the splat kernel's launches."""
    import torch

    batches = LOOP_TRAIN_IMAGES // BIG_BATCH
    out.mkdir(parents=True, exist_ok=True)
    _, wall = run_refused(
        "monocon_tpu_torch.train",
        ["--config_file", CONFIG_FILE, "--set", "DATA.ROOT", str(root),
         "--set", "OUTPUT_DIR", str(out),
         "--set", "SOLVER.OPTIM.NUM_EPOCHS", "1",
         "--set", "TPU.GRAD_ACCUM_STEPS", str(CONFIG_ACCUM),
         "--set", "PERIOD.EVAL_PERIOD", "1"],
        out / "config_run.log", launches=2 * batches,
        timeout=TRAIN_CLI_TIMEOUT_S)
    saved = (out / "config.yaml").read_text()
    for line in ('COMPUTE_DTYPE: "bfloat16"', f"BATCH_SIZE: {BIG_BATCH}",
                 f"GRAD_ACCUM_STEPS: {CONFIG_ACCUM}"):
        if line not in saved:
            raise AssertionError(f"configs: config.yaml lacks {line!r}")
    container, meta, ap = read_run(out)
    solver = container["state_dict"]["scheduler"]
    if (solver["count"], solver["mini_step"]) != (batches // CONFIG_ACCUM, 0):
        raise AssertionError(f"configs: the config-file run's solver is at "
                             f"{solver['count']} steps, micro-step "
                             f"{solver['mini_step']}")
    if len(meta["entire_losses"]) != batches:
        raise AssertionError(f"configs: {len(meta['entire_losses'])} losses "
                             f"for {batches} batches")
    check_losses(meta["entire_losses"], "config-file run")
    check_ap(ap)
    del container
    log(f"[configs] python -m monocon_tpu_torch.train --config_file "
        f"{CONFIG_FILE} (PyYAML, OpenCV and PIL refused; bfloat16, batch "
        f"{BIG_BATCH}, TPU.GRAD_ACCUM_STEPS {CONFIG_ACCUM}): {batches} "
        f"micro-batches, schedule count {solver['count']}, splat launches "
        f"{2 * batches} (2 per micro-batch), losses {meta['entire_losses']}, evaluation 84 finite "
        f"AP keys; {wall:.3f} s wall (process start, builds, one epoch, the "
        f"evaluation, the checkpoints)")
    torch.cuda.empty_cache()
    return 2 * batches


def write_drive(root: Path) -> "tuple[Path, Path]":
    """A synthetic KITTI raw drive: ``STREAM_FRAMES`` PNG frames (smooth
    random backgrounds, as the generator renders them) and a
    ``calib_cam_to_cam.txt`` with the generator's P2."""
    from monocon_tpu_torch.data.png import write_png
    from monocon_tpu_torch.data.synthetic import DEFAULT_P2, render_scene

    frames = root / "image_02" / "data"
    frames.mkdir(parents=True)
    for i in range(STREAM_FRAMES):
        write_png(frames / f"{i:010d}.png",
                  render_scene(np.random.default_rng((SEED, i)), STREAM_HW,
                               [], DEFAULT_P2))
    calib = root / "calib_cam_to_cam.txt"
    calib.write_text("P_rect_02: " + " ".join(
        f"{v:.6e}" for v in DEFAULT_P2.reshape(-1)) + "\n")
    return frames, calib


def run_refused(module: str, args, log_path: Path, launches: int = 0,
                timeout: float = STREAM_CLI_TIMEOUT_S,
                launcher=()) -> "tuple[str, float]":
    """``python -m module args`` with OpenCV, PIL and PyYAML refused, after
    ``launcher`` (a command that runs the interpreter, e.g. torchrun's);
    (stdout, wall seconds). Fails unless it exits 0 and launched the splat
    kernel ``launches`` times."""
    t0 = time.perf_counter()
    proc = subprocess.run([*launcher, sys.executable, "-c", REFUSED_RUN,
                           module, *args],
                          cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    log_path.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"{module} exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    said = [int(line.split()[1]) for line in proc.stdout.splitlines()
            if line.startswith("SPLAT_LAUNCHES")]
    if said != [launches]:
        raise AssertionError(f"{module} launched the splat kernel {said} "
                             f"times, expected {launches}")
    return proc.stdout, wall


def check_pngs(folder: Path, names, hw) -> None:
    from monocon_tpu_torch.data.png import read_png

    got = sorted(p.name for p in folder.glob("*.png"))
    if got != sorted(names):
        raise AssertionError(f"stream: {folder} holds {len(got)} PNGs, "
                             f"expected {len(names)}")
    for name in names:
        shape = read_png(folder / name).shape
        if shape != (*hw, 3):
            raise AssertionError(f"stream: {folder / name} is {shape}")


def same_vis(got, want, what: str) -> "tuple[int, float]":
    """Vis results frame by frame: labels equal, 2D and 3D boxes within
    ``PIPELINE_TOL``. Returns (boxes compared, largest |diff|)."""
    if len(got) != len(want):
        raise AssertionError(f"stream: {what}: {len(got)} frames, "
                             f"{len(want)} unpipelined")
    count, worst = 0, 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        pairs = [(g["img_bbox"]["boxes_3d"], w["img_bbox"]["boxes_3d"]),
                 (g["img_bbox"]["scores_3d"], w["img_bbox"]["scores_3d"]),
                 *zip(g["img_bbox2d"], w["img_bbox2d"])]
        if not np.array_equal(g["img_bbox"]["labels_3d"],
                              w["img_bbox"]["labels_3d"]):
            raise AssertionError(f"stream: {what} frame {i}: labels differ")
        for a, b in pairs:
            if a.shape != b.shape or not np.allclose(a, b, **PIPELINE_TOL):
                raise AssertionError(f"stream: {what} frame {i}: {a} against "
                                     f"{b}")
            if b.size:
                worst = max(worst, float(np.abs(a - b).max()))
        count += len(w["img_bbox"]["labels_3d"])
    return count, worst


def phase_stream(tmp: Path, eval_root: Path) -> int:
    """Streaming and visualization (phase 9). Returns the splat kernel's
    launches on these paths (0)."""
    import torch

    from monocon_tpu_torch import create_detector
    from monocon_tpu_torch.config import export_cfg, get_default_cfg
    from monocon_tpu_torch.data.kitti_raw import KITTIRawDataset
    from monocon_tpu_torch.data.transforms import default_raw_transforms
    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.test_raw import make_stream
    from monocon_tpu_torch.utils.streaming import pipelined_frames

    t0 = time.perf_counter()
    frames_dir, calib = write_drive(tmp / "drive")
    log(f"[stream] wrote a drive of {STREAM_FRAMES} PNG frames at "
        f"{STREAM_HW[0]}x{STREAM_HW[1]} in {time.perf_counter() - t0:.3f} s")
    model = create_detector(34, generator=torch.Generator().manual_seed(SEED),
                            device=DEVICE).eval()
    pth = tmp / "stream_model.pth"
    torch.save({"state_dict": {"model": model.state_dict()}}, pth)
    dataset = KITTIRawDataset(str(frames_dir), str(calib),
                              default_raw_transforms(device_normalize=True))
    splat.launch_count = 0
    for batch in STREAM_BATCHES:
        frames, infer, finalize = make_stream(model, dataset, DEVICE, batch,
                                              0.0)
        finalize(infer(frames[0]), frames[0])      # warm-up
        # Unpipelined: load, queue, wait and convert one batch at a time.
        walls, want = [], []
        for j in range(len(frames)):
            t0 = time.perf_counter()
            sample = frames[j]
            want += finalize(infer(sample), sample)
            walls.append(time.perf_counter() - t0)
        # Pipelined, with the loop's wait for the next loaded batch: the
        # time from a finalize's return to the next infer's call.
        marks = {"wait": 0.0, "last": None}

        def timed_infer(sample):
            now = time.perf_counter()
            marks["wait"] += now - marks["last"]
            return infer(sample)

        def timed_finalize(dispatched, sample):
            out = finalize(dispatched, sample)
            marks["last"] = time.perf_counter()
            return out

        got = []
        t0 = marks["last"] = time.perf_counter()
        for vis in pipelined_frames(frames, timed_infer, timed_finalize):
            got += vis
        stream_s = time.perf_counter() - t0
        compared, worst = same_vis(got, want, f"B={batch}")
        latency = (f"; latency (median per-frame wall, unpipelined) "
                   f"{np.median(walls) * 1e3:.3f} ms" if batch == 1 else "")
        log(f"[stream] B={batch}: {STREAM_FRAMES / stream_s:.3f} frames/s "
            f"end to end pipelined ({stream_s:.3f} s), waited "
            f"{marks['wait']:.3f} s ({marks['wait'] / stream_s:.1%}) for "
            f"frame loading; unpipelined {STREAM_FRAMES / sum(walls):.3f} "
            f"frames/s{latency}; {compared} boxes equal to the unpipelined "
            f"run (labels exact, rtol 1e-6 / atol 1e-6), max |diff| "
            f"{worst:.3g}")
    if splat.launch_count:
        raise AssertionError("stream: the splat kernel ran on the stream")
    del model
    torch.cuda.empty_cache()

    out = tmp / "raw_results"
    stdout, wall = run_refused(
        "monocon_tpu_torch.test_raw",
        ["--data_dir", str(frames_dir), "--calib_file", str(calib),
         "--checkpoint_file", str(pth), "--save_dir", str(out), "--batch",
         "8", "--score_threshold", "0"], tmp / "test_raw.log")
    names = [f"{i:06d}.png" for i in range(STREAM_FRAMES)]
    for item, hw in (("2d", STREAM_HW), ("3d", STREAM_HW), ("bev", BEV_HW)):
        check_pngs(out / item, names, hw)
    said = [line for line in stdout.splitlines()
            if line.startswith(("Streamed", "Frames exported"))]
    log(f"[stream] python -m monocon_tpu_torch.test_raw --batch 8 "
        f"--score_threshold 0 (OpenCV, PIL, PyYAML refused): {wall:.3f} s "
        f"wall; 3 x {STREAM_FRAMES} PNGs read back; it said: "
        + " | ".join(said))

    # test --visualize on 16 images of the eval tree: its (empty) train
    # split file is given their ids.
    ids = sorted(p.stem for p in (eval_root / "training" / "image_2").glob(
        "*.png"))[:VIS_IMAGES]
    (eval_root / "ImageSets" / "train.txt").write_text("\n".join(ids) + "\n")
    cfg = get_default_cfg()
    cfg.DATA.ROOT, cfg.DATA.TEST_SPLIT = str(eval_root), "train"
    export_cfg(cfg, str(tmp / "vis.yaml"))
    vis_out = tmp / "vis_results"
    _, wall = run_refused(
        "monocon_tpu_torch.test",
        ["--config_file", str(tmp / "vis.yaml"), "--checkpoint_file",
         str(pth), "--visualize", "--save_dir", str(vis_out)],
        tmp / "visualize.log")
    for item, hw in (("2d", EVAL_IMAGE_HW), ("3d", EVAL_IMAGE_HW),
                     ("bev", BEV_HW)):
        check_pngs(vis_out / item, [f"{i}.png" for i in ids], hw)
    log(f"[stream] python -m monocon_tpu_torch.test --visualize on "
        f"{VIS_IMAGES} images (OpenCV, PIL, PyYAML refused): {wall:.3f} s "
        f"wall (process start, model, one pass, 3 x {VIS_IMAGES} PNGs read "
        "back); splat launches 0 on both")
    return splat.launch_count


def same_losses(got: dict, want: dict, what: str) -> float:
    """Every loss of ``got`` within rtol 1e-3 / atol 1e-4 of ``want``'s;
    returns the largest |difference|."""
    if set(got) != set(want) or len(want) != 11:
        raise AssertionError(f"parallel: {what}: losses {sorted(got)}")
    worst = 0.0
    for key, value in want.items():
        err = abs(got[key] - value)
        if not (np.isfinite(got[key]) and err <= 1e-4 + 1e-3 * abs(value)):
            raise AssertionError(f"parallel: {what}: {key} {got[key]} "
                                 f"against {value}")
        worst = max(worst, err)
    return worst


def timed_train_steps(model, steps: int, batch, device,
                      layout=None) -> dict:
    """``steps`` train steps of ``model`` (plain or DDP-wrapped) on
    ``batch`` (with ``layout``, this rank's band): the first step's
    losses, ms/step of steps 1.. (host clock, each ending in a
    synchronise), peak memory and splat launches."""
    import torch

    from monocon_tpu_torch import build_optimizer, train_step
    from monocon_tpu_torch.ops import splat

    optimizer, solver = build_optimizer(model.parameters(),
                                        total_steps=steps)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    splat.launch_count = 0
    times, first = [], None
    for _ in range(steps):
        t0 = time.perf_counter()
        losses = train_step(model, optimizer, solver, batch, layout)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        values = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise AssertionError(f"parallel: non-finite losses {values}")
        first = first or values
    return {"losses": first, "ms": float(np.mean(times[1:])) * 1e3,
            "peak": torch.cuda.max_memory_allocated(device),
            "launches": splat.launch_count}


def rank_batch(device, rank: int, world: int):
    """Rank ``rank``'s rows of the isolated train step's batch (B=8)."""
    batch = train_batch(np.random.default_rng(SEED + 1), TRAIN_BATCH, PAD_HW,
                        device)
    rows = slice(rank * TRAIN_BATCH // world,
                 (rank + 1) * TRAIN_BATCH // world)
    return {"img": batch["img"][rows],
            "label": {k: v[rows] for k, v in batch["label"].items()}}


def phase_world_of_one() -> "tuple[dict, int]":
    """Phase 11a: a process group of one rank through NCCL, joined from
    torchrun's environment set here. A DDP-wrapped DLA-34 float32 step at
    B=8 against the plain step from the same weights and batch, in turns
    (plain, DDP, DDP, plain). Returns the first plain turn (its first
    losses, ms/step and peak memory) and the DDP turns' splat launches."""
    import torch
    import torch.distributed as dist

    from monocon_tpu_torch import create_detector
    from monocon_tpu_torch.parallel import (data_parallel,
                                            initialize_distributed)
    from monocon_tpu_torch.parallel.distributed import free_port

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    device = initialize_distributed("cuda")
    try:
        log(f"[parallel] world of one: backend {dist.get_backend()}, "
            f"device {device}")
        batch = rank_batch(device, 0, 1)
        turns = []
        for kind in ("plain", "ddp", "ddp", "plain"):
            model = create_detector(
                34, generator=torch.Generator().manual_seed(SEED),
                device=device)
            if kind == "ddp":
                model = data_parallel(model, device)
            turns.append((kind, timed_train_steps(model, PARALLEL_STEPS,
                                                  batch, device)))
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(key)
    plain = turns[0][1]
    launches = 0
    for kind, run in turns:
        worst = same_losses(run["losses"], plain["losses"], f"{kind} turn")
        if run["launches"] != 2 * PARALLEL_STEPS:
            raise AssertionError(f"parallel: {kind}: splat launched "
                                 f"{run['launches']} times")
        launches += run["launches"] if kind == "ddp" else 0
        log(f"[parallel] {kind:5s} B={TRAIN_BATCH} {PAD_HW[0]}x{PAD_HW[1]} "
            f"float32: {run['ms']:.3f} ms/step over steps 1-"
            f"{PARALLEL_STEPS - 1}, max_memory_allocated {run['peak']} "
            f"bytes, splat launches {run['launches']}, first losses within "
            f"{worst:.3g} of the plain turn's")
    return plain, launches


def two_rank_worker(out_path: str) -> None:
    """One of two ranks on card 0 through gloo (phase 11b), run by
    ``python -c``: DLA-34 float32 under ``data_parallel``, its 4 rows of
    the B=8 batch, ``PARALLEL_STEPS`` steps. Writes the losses, ms/step,
    peak memory, splat launches and a SHA-256 of its parameters' bytes."""
    import hashlib

    import torch
    import torch.distributed as dist

    from monocon_tpu_torch import create_detector
    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.parallel import (data_parallel,
                                            initialize_distributed,
                                            rank_and_world)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize_distributed("cuda", backend="gloo")
    rank, world = rank_and_world()
    model = data_parallel(create_detector(
        34, generator=torch.Generator().manual_seed(SEED), device=device),
        device)
    run = timed_train_steps(model, PARALLEL_STEPS,
                            rank_batch(device, rank, world), device)
    digest = hashlib.sha256()
    for p in model.module.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    run["params_sha256"] = digest.hexdigest()
    Path(out_path).write_text(json.dumps(run))
    dist.destroy_process_group()


def phase_two_ranks(tmp: Path, plain: dict) -> int:
    """Phase 11b: two ranks on the one card through gloo, B=4 each (NCCL
    refuses two ranks on one device). Their global losses against one
    process's at B=8 (phase 11a's plain step), parameters bit-equal across
    the ranks after the steps, 2 splat launches per step per rank.
    Returns the ranks' splat launches."""
    import torch

    from monocon_tpu_torch.parallel.distributed import free_port

    gc.collect()
    torch.cuda.empty_cache()
    port, procs, outs = free_port(), [], []
    t0 = time.perf_counter()
    for rank in range(2):
        outs.append(tmp / f"two_ranks_{rank}.json")
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.two_rank_worker(sys.argv[1])", str(outs[-1])],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=TWO_RANK_TIMEOUT_S)[0] for p in procs]
    wall = time.perf_counter() - t0
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        (tmp / f"two_ranks_{rank}.log").write_text(text)
        if proc.returncode != 0:
            raise AssertionError(f"parallel: rank {rank} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
    runs = [json.loads(o.read_text()) for o in outs]
    if runs[0]["params_sha256"] != runs[1]["params_sha256"]:
        raise AssertionError("parallel: the two ranks' parameters differ "
                             f"after {PARALLEL_STEPS} steps")
    launches = 0
    for rank, run in enumerate(runs):
        worst = same_losses(run["losses"], plain["losses"],
                            f"rank {rank} of 2")
        if run["launches"] != 2 * PARALLEL_STEPS:
            raise AssertionError(f"parallel: rank {rank}: splat launched "
                                 f"{run['launches']} times")
        launches += run["launches"]
        log(f"[parallel] two ranks on one card (gloo), rank {rank}, B=4 of "
            f"8: {run['ms']:.3f} ms/step over steps 1-{PARALLEL_STEPS - 1}, "
            f"max_memory_allocated {run['peak']} bytes, splat launches "
            f"{run['launches']}, first global losses within {worst:.3g} of "
            "one process at B=8")
    log(f"[parallel] the two ranks' parameters are bit-equal after "
        f"{PARALLEL_STEPS} steps (SHA-256 {runs[0]['params_sha256'][:16]}); "
        f"{wall:.3f} s wall for both processes")
    return launches


def phase_torchrun_cli(root: Path, out: Path) -> int:
    """Phase 11c: the train CLI under ``torchrun --nproc_per_node 1`` with
    OpenCV, PIL and PyYAML refused, on the train-loop phase's tree: one
    epoch, an evaluation. Returns the splat kernel's launches."""
    out.mkdir(parents=True, exist_ok=True)
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "--no-python"]
    stdout, wall = run_refused(
        "monocon_tpu_torch.train",
        ["--data_root", str(root), "--output_dir", str(out),
         "--num_epochs", "1", "--set", "SEED", "0",
         "--set", "PERIOD.EVAL_PERIOD", "1"],
        out / "torchrun.log", launches=2 * LOOP_STEPS,
        timeout=TRAIN_CLI_TIMEOUT_S, launcher=torchrun)
    _, meta, ap = read_run(out)
    check_losses(meta["entire_losses"], "torchrun CLI")
    check_ap(ap)
    saved = sorted(p.name for p in (out / "checkpoints").iterdir())
    if saved != ["epoch_001", "epoch_001_final"]:
        raise AssertionError(f"parallel: torchrun CLI wrote {saved}")
    if stdout.count("MonoCon Engine (PyTorch port)") != 1:
        raise AssertionError("parallel: torchrun CLI printed its banner "
                             "more than once")
    log(f"[parallel] torchrun --nproc_per_node 1 -m monocon_tpu_torch.train "
        f"(OpenCV, PIL, PyYAML refused): {LOOP_STEPS} steps, losses "
        f"{meta['entire_losses']}, 84 finite AP keys, checkpoints {saved}, "
        f"splat launches {2 * LOOP_STEPS}; {wall:.3f} s wall")
    return 2 * LOOP_STEPS


def spatial_worker(out_path: str) -> None:
    """One of two ranks on card 0 through gloo (phase 13), run by
    ``python -c``: a 1 data x 2 space layout of the 384x1280 canvas,
    DLA-34 float32 from the seed, this rank's band (192 rows) of the whole
    B=8 batch. First, in eval mode, the banded forward + decode of the
    batch against the same model's plain forward + decode of the whole
    images; then ``PARALLEL_STEPS`` train steps under ``data_parallel``
    (the first not timed), the backbone's and the neck's output heights
    in the first; then the trained model's two forwards once more (their
    largest difference over each map's largest value, printed only: four
    steps on random labels can push the depth map's ``1/sigmoid - 1`` to
    values where float32 rounding alone moves it by more than 1e-3).
    Writes the losses, ms/step, peak memory, splat launches, a SHA-256 of
    the parameters' bytes, the heights and the eval comparisons."""
    import hashlib

    import torch
    import torch.distributed as dist

    from monocon_tpu_torch import create_detector, decode_predictions
    from monocon_tpu_torch.ops.decode import DEFAULT_P2
    from monocon_tpu_torch.ops.image_norm import normalize_if_raw
    from monocon_tpu_torch.parallel import (data_parallel,
                                            initialize_distributed,
                                            spatial_layout, spatial_scope)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize_distributed("cuda", backend="gloo")
    layout = spatial_layout(PAD_HW[0], 2)
    model = create_detector(
        34, generator=torch.Generator().manual_seed(SEED), device=device)
    whole = rank_batch(device, 0, 1)
    start, stop = layout.band
    batch = {"img": whole["img"][:, start:stop], "label": whole["label"]}

    def forwards():
        """(banded, whole-image) eval predictions of the batch."""
        model.eval()
        with torch.no_grad():
            plain = model(normalize_if_raw(whole["img"]))
            with spatial_scope(model, layout):
                banded = model(normalize_if_raw(batch["img"], row0=start))
        if any(banded[k].shape != plain[k].shape
               or not torch.isfinite(banded[k]).all() for k in plain):
            raise AssertionError("spatial: banded head maps' shapes or "
                                 "values")
        return banded, plain

    run = {}
    banded, plain = forwards()
    p2 = torch.from_numpy(np.tile(DEFAULT_P2[None], (TRAIN_BATCH, 1, 1))
                          ).to(device)
    decoded = [decode_predictions(pred, p2, PAD_HW)
               for pred in (banded, plain)]
    errors = {k: float((banded[k] - plain[k]).abs().max()) for k in plain}
    run["eval_max_abs"] = max(errors.values())
    run["top30_matched"] = sum(
        check_top30((top30_keys(banded, b), decoded[0]),
                    (top30_keys(plain, b), decoded[1]), b,
                    errors["center_heatmap_pred"],
                    f"spatial: image {b}, bands against whole")
        for b in range(TRAIN_BATCH))

    heights = {}

    def record(name):
        def hook(module, args, out):
            outs = out if isinstance(out, tuple) else (out,)
            heights.setdefault(name, [t.shape[2] for t in outs])
        return hook

    hooks = [model.backbone.register_forward_hook(record("backbone")),
             model.neck.register_forward_hook(record("neck"))]
    run.update(timed_train_steps(data_parallel(model, device),
                                 PARALLEL_STEPS, batch, device, layout))
    for h in hooks:
        h.remove()
    digest = hashlib.sha256()
    for p in model.parameters():
        digest.update(p.detach().cpu().numpy().tobytes())
    run.update(params_sha256=digest.hexdigest(), heights=heights,
               band=[start, stop])
    banded, plain = forwards()
    run["trained_eval_rel"] = max(
        float((banded[k] - plain[k]).abs().max() / plain[k].abs().max())
        for k in plain)
    Path(out_path).write_text(json.dumps(run))
    dist.destroy_process_group()


def phase_spatial(tmp: Path, plain: dict) -> int:
    """Phase 13: the image height split over two ranks on the one card
    through gloo (1 data x 2 space, 384x1280, B=8, DLA-34 float32). The
    first step's global losses against one process's (phase 11a's plain
    step), parameters bit-equal across the ranks, 2 splat launches per
    step per rank, every backbone level and the neck's output at band
    height; the banded eval forward's head maps (the model from the seed)
    within ``HEAD_ATOL`` of the whole-image forward's and the top-30 equal
    up to ties. Returns the ranks' splat launches."""
    import torch

    from monocon_tpu_torch.parallel.distributed import free_port

    gc.collect()
    torch.cuda.empty_cache()
    port, procs, outs = free_port(), [], []
    t0 = time.perf_counter()
    for rank in range(2):
        outs.append(tmp / f"spatial_{rank}.json")
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_RANK="0", MASTER_ADDR="localhost",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.spatial_worker(sys.argv[1])", str(outs[-1])],
            cwd=Path(__file__).resolve().parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=TWO_RANK_TIMEOUT_S)[0] for p in procs]
    wall = time.perf_counter() - t0
    for rank, (proc, text) in enumerate(zip(procs, logs)):
        (tmp / f"spatial_{rank}.log").write_text(text)
        if proc.returncode != 0:
            raise AssertionError(f"spatial: rank {rank} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
    runs = [json.loads(o.read_text()) for o in outs]
    if runs[0]["params_sha256"] != runs[1]["params_sha256"]:
        raise AssertionError("spatial: the two ranks' parameters differ "
                             f"after {PARALLEL_STEPS} steps")
    launches = 0
    for rank, run in enumerate(runs):
        worst = same_losses(run["losses"], plain["losses"],
                            f"spatial rank {rank} of 2")
        if run["launches"] != 2 * PARALLEL_STEPS:
            raise AssertionError(f"spatial: rank {rank}: splat launched "
                                 f"{run['launches']} times")
        band = run["band"][1] - run["band"][0]
        want = {"backbone": [band >> i for i in range(6)],
                "neck": [band // 4]}
        if run["heights"] != want or band >= PAD_HW[0]:
            raise AssertionError(f"spatial: rank {rank}'s activation "
                                 f"heights {run['heights']}, not {want}")
        if run["eval_max_abs"] > HEAD_ATOL:
            raise AssertionError(f"spatial: rank {rank}: banded head maps "
                                 f"{run['eval_max_abs']} from the whole "
                                 "image's")
        launches += run["launches"]
        log(f"[spatial] rank {rank} of 1x2, rows {run['band']}, B={TRAIN_BATCH}"
            f" {PAD_HW[0]}x{PAD_HW[1]} float32: {run['ms']:.3f} ms/step over "
            f"steps 1-{PARALLEL_STEPS - 1} (one process: {plain['ms']:.3f}),"
            f" max_memory_allocated {run['peak']} bytes (one process: "
            f"{plain['peak']}), splat launches {run['launches']}, first "
            f"global losses within {worst:.3g} of one process; backbone "
            f"heights {run['heights']['backbone']}, neck "
            f"{run['heights']['neck']}; eval head maps within "
            f"{run['eval_max_abs']:.3g} of the whole image's, top-30 "
            f"{run['top30_matched']} of {30 * TRAIN_BATCH} matched, the rest "
            f"ties; after the steps within {run['trained_eval_rel']:.3g} of "
            "each map's largest value")
    log(f"[spatial] the two ranks' parameters are bit-equal after "
        f"{PARALLEL_STEPS} steps (SHA-256 {runs[0]['params_sha256'][:16]}); "
        f"{wall:.3f} s wall for both processes")
    return launches


def phase_overfit(tmp: Path) -> "tuple[int, list[dict]]":
    """Phase 14: the overfit check at ``OVERFIT_STEPS`` steps on the card.
    Returns the splat kernel's launches and the two timed splat calls of
    the overfit's batch."""
    from monocon_tpu_torch.checks.overfit import (IMAGE_HW, overfit_batch,
                                                  run_overfit, write_tree)
    from monocon_tpu_torch.config import get_default_cfg
    from monocon_tpu_torch.engine.train_step import FEAT_STRIDE
    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.train import configure_backends

    root = tmp / "overfit"
    write_tree(str(root))
    configure_backends(get_default_cfg(), deterministic=False)
    # The kernel on the overfit's own inputs (the tree's labels at the
    # check's canvas), before the counted run.
    _, _, batch = overfit_batch(str(root), DEVICE)
    feat_hw = (IMAGE_HW[0] // FEAT_STRIDE, IMAGE_HW[1] // FEAT_STRIDE)
    _, calls = capture_splat_inputs(batch, feat_hw, IMAGE_HW)
    shapes = time_splat_calls(calls, "overfit")
    del batch, calls
    t0 = time.perf_counter()
    splat.launch_count = 0
    result = run_overfit(str(root), steps=OVERFIT_STEPS, device=DEVICE)
    launches = splat.launch_count
    wall = time.perf_counter() - t0
    first, last = result["log"][0], result["final"]
    log(f"[overfit] step 0 losses {json.dumps(first)}")
    log(f"[overfit] step {OVERFIT_STEPS - 1} losses {json.dumps(last)}")
    log(f"[overfit] {len(result['nonzero_ap'])} nonzero AP entries "
        f"{json.dumps(result['nonzero_ap'])}; detections per image "
        f"{result['detections']}")
    log(f"[overfit] {OVERFIT_STEPS} steps of B=4 at 192x640, float32: "
        f"{result['ms_per_step']:.3f} ms/step, {wall:.3f} s wall with the "
        f"loader and the evaluation; splat launches {launches}; rule "
        f"{'PASS' if result['passed'] else 'FAIL'}")
    if launches != 2 * OVERFIT_STEPS:
        raise AssertionError(f"overfit: the splat kernel launched {launches} "
                             f"times in {OVERFIT_STEPS} steps, expected 2 "
                             "per step")
    if not result["passed"]:
        raise AssertionError(
            f"overfit: the rule fails: center-heatmap loss "
            f"{last['loss_center_heatmap']}, "
            f"{len(result['nonzero_ap'])} nonzero AP entries")
    return launches, shapes


def phase_eval_scale(tmp: Path, train_ms_per_step: float) -> int:
    """Phase 15: ``checks.eval_scale`` at ``EVAL_SCALE_IMAGES`` images on
    the card's host, its AP dict against the JAX package's. Returns the
    splat kernel's launches (0)."""
    from monocon_tpu_torch.checks import eval_scale
    from monocon_tpu_torch.ops import splat

    out = tmp / "eval_scale.json"
    splat.launch_count = 0
    code = eval_scale.main(["--images", str(EVAL_SCALE_IMAGES),
                            "--train-ms-per-step", repr(train_ms_per_step),
                            "--profile", "--json", str(out)])
    launches = splat.launch_count
    record = json.loads(out.read_text())
    log(f"[eval_scale] record {json.dumps(record)}")
    if code != 0 or record["ap_equals_jax"] is not True:
        raise AssertionError(f"eval_scale: exit {code}, the AP dict equal to "
                             f"the JAX package's: {record['ap_equals_jax']}")
    if record["ap_keys"] != EVAL_SCALE_AP_KEYS or launches:
        raise AssertionError(f"eval_scale: {record['ap_keys']} AP keys, "
                             f"{launches} splat launches")
    period = record["eval_period"]
    log(f"[eval_scale] {EVAL_SCALE_IMAGES} images on "
        f"{record['device']['host']} (card {record['device']['card']}): "
        f"kitti_eval {record['end_to_end_cpp_s']:.6f} s end to end, AP dict "
        f"equal to the JAX package's ({record['ap_keys']} keys); stages "
        f"(least of {record['stage_repeats']}) "
        + ", ".join(f"{k} {v:.6f} s" for k, v in record["stages_3d"].items())
        + f"; {period['eval_share']:.4%} of an EVAL_PERIOD "
        f"({period['steps']} bf16 B={period['batch']} steps at "
        f"{period['train_ms_per_step']:.3f} ms); splat launches {launches}")
    return launches


def run_bench(env: dict) -> dict:
    """``python -m monocon_tpu_torch.bench`` with ``env`` added: its JSON
    line, printed, and checked."""
    proc = subprocess.run(
        [sys.executable, "-m", "monocon_tpu_torch.bench"],
        cwd=Path(__file__).resolve().parent, env={**os.environ, **env},
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"bench exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"[bench] {' '.join(f'{k}={v}' for k, v in env.items())}: {line}")
    result = json.loads(line)
    if not BENCH_KEYS <= set(result):
        raise AssertionError(f"bench: keys {sorted(result)}")
    if result["vs_baseline"] is not None or result["torch_fps"] is not None:
        raise AssertionError("bench: vs_baseline and torch_fps must be null")
    if not (result["mfu_pct"] is not None and 0 < result["mfu_pct"] <= 100):
        raise AssertionError(f"bench: mfu_pct {result['mfu_pct']}")
    if not (result["value"] > 0 and result["device_ms_per_step"] > 0):
        raise AssertionError(f"bench: {result}")
    return result


def phase_bench(tmp: Path) -> None:
    """Phase 12: the bench at its defaults (B=128, bf16) and in float32 at
    B=8; then a traced serve loop (DLA-34 float32, B=8, 10 iterations):
    its kernel seconds from ``device_op_seconds`` positive and at most
    1.05x the CUDA-event time of the same loop."""
    import torch

    from monocon_tpu_torch.bench import make_forward
    from monocon_tpu_torch.utils.profiling import (device_op_seconds,
                                                   device_trace)

    run_bench({})
    run_bench({"BENCH_DTYPE": "float32", "BENCH_BATCH": str(TRAIN_BATCH)})

    _, forward, image, p2 = make_forward(34, "float32", SERVE_BATCH,
                                         torch.device(DEVICE))
    for _ in range(3):
        forward(image, p2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    iters = 10
    with device_trace(str(tmp / "serve_trace")):
        start.record()
        for _ in range(iters):
            forward(image, p2)
        end.record()
        torch.cuda.synchronize()
    kernel_s = device_op_seconds(str(tmp / "serve_trace"))
    event_s = start.elapsed_time(end) / 1e3
    if not 0 < kernel_s <= 1.05 * event_s:
        raise AssertionError(f"profiling: kernels {kernel_s} s against "
                             f"events {event_s} s")
    log(f"[bench] traced serve loop, {iters} x B={SERVE_BATCH} float32: "
        f"device_op_seconds {kernel_s:.6f} s, CUDA events {event_s:.6f} s "
        f"({kernel_s / event_s:.1%} of the span in kernels)")


def main() -> int:
    import torch

    from monocon_tpu_torch.ops import batch_norm as bn

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    card = phase_environment()
    phase_build()
    rng = np.random.default_rng(SEED)
    step_calls, worst = phase_kernel(rng)
    bn_calls, bn_worst = phase_batch_norm()
    bn.launch_count = 0
    phase_serve()
    by_path = {"train_step": phase_train()}
    with tempfile.TemporaryDirectory() as tmp:
        phase_eval(Path(tmp))
        by_path["eval"] = 0
        by_path["stream"] = phase_stream(Path(tmp), Path(tmp) / "kitti")
    with tempfile.TemporaryDirectory() as tmp:
        loop_calls, loop_launches = phase_train_loop(Path(tmp))
        by_path.update(loop_launches)
        gc.collect()
        torch.cuda.empty_cache()
        by_path["train_step_bf16"], bf16_b16_ms, bn_step = phase_bf16()
        by_path["train_step_dla102"] = phase_dla102()
        by_path["config_file_run"] = phase_config_file(
            Path(tmp) / "kitti_train", Path(tmp) / "run_config")
        plain, by_path["ddp_world_of_one"] = phase_world_of_one()
        by_path["two_ranks_gloo"] = phase_two_ranks(Path(tmp), plain)
        by_path["torchrun_cli"] = phase_torchrun_cli(
            Path(tmp) / "kitti_train", Path(tmp) / "run_torchrun")
        phase_bench(Path(tmp))
        by_path["spatial"] = phase_spatial(Path(tmp), plain)
        by_path["overfit"], overfit_calls = phase_overfit(Path(tmp))
        by_path["eval_scale"] = phase_eval_scale(Path(tmp), bf16_b16_ms)
    # The numbers of the path whose launches the line reports: run D's.
    entry = splat_entry(loop_calls, max(
        worst, *(s["max_abs_err"] for s in loop_calls + overfit_calls)))
    entry["per_call_train_step"] = step_calls
    entry["per_call_overfit"] = overfit_calls
    entry["launches"] = by_path["train_loop_D"]
    entry["launches_by_path"] = by_path
    print(card, flush=True)
    print(json.dumps({"kernels": [entry, bn_entry(
        bn_calls, bn_worst, bn_step, bn.launch_count)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
