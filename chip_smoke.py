#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``monocon_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no
result line:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for convolutions and matrix products;
2. build: compiles ``monocon_tpu_torch/csrc/splat.cu`` with nvcc;
3. kernel vs plain: the splat kernel against its plain PyTorch version on
   the card, on the train step's own inputs at 384x1280 (B=8, feature map
   96x320: C=3 N=30 and C=9 N=270), on dense random instances at the same
   shapes and on edge cases (boxes on each side of a tile border, ragged
   W and H, N above one cull round, N above 48 KB of shared list, one
   channel, N=0, radius 0, an all-invalid element), and an N past the
   shared list must be refused; then every target of one train batch,
   card against CPU;
4. serve: DLA-34 (random weights from a seed) at 384x1280, float32, eval
   forward + 3D decode, one image on the card against the CPU, then
   frames/s at batch 8;
5. train: one step at 64x160 on the card against the CPU, then five
   ``train_step``s at 384x1280, B=8, uint8 images; the splat kernel must
   launch twice per step;
6. kernels line: one JSON object per hand-written kernel.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", ...}}``. Needs a CUDA device;
without one it exits 1 before any phase.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

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


def phase_kernel(rng) -> dict:
    """The kernel against its plain version; returns the kernels-line
    entry (without ``launches``)."""
    import torch

    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.ops.targets import generate_targets

    worst = 0.0

    def check(args, c, h, w, what):
        nonlocal worst
        got = splat.splat_max_heatmap_cuda(*args, c, h, w)
        want = splat.splat_max_heatmap_plain(*args, c, h, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        log(f"[kernel] {what}: B={args[1].shape[0]} N={args[1].shape[1]} "
            f"C={c} {h}x{w}: max|kernel - plain| = {err:.3g}")
        if not err <= SPLAT_TOL:
            raise AssertionError(f"splat kernel disagrees on {what}: {err}")
        worst = max(worst, err)
        return got

    # The main path's own inputs: one train batch's two splat calls.
    batch = train_batch(np.random.default_rng(SEED + 1), TRAIN_BATCH, PAD_HW,
                        DEVICE)
    targets_gpu, calls = capture_splat_inputs(batch, FEAT_HW, PAD_HW)
    if len(calls) != 2:
        raise AssertionError(f"expected 2 splat calls, saw {len(calls)}")
    shapes = []
    for name, (*args, c, h, w) in zip(("center", "keypoint"), calls):
        check(args, c, h, w, f"main path, {name} heatmap")

        def kernel():
            splat.splat_max_heatmap_cuda(*args, c, h, w)

        def plain():
            splat.splat_max_heatmap_plain(*args, c, h, w)

        bound_ms, bound_by = splat_bound_ms(args, c, h, w)
        ms = graph_ms(kernel, 50)
        shapes.append(dict(
            name=name, b=args[1].shape[0], n=args[1].shape[1], c=c, h=h,
            w=w, ms=ms, plain_ms=graph_ms(plain, 5), bound_ms=bound_ms,
            bound_by=bound_by, bound_share=bound_ms / ms,
            host_ms=host_ms(kernel, 200)))
        log(f"[kernel] {name}: kernel {ms:.6f} ms, plain "
            f"{shapes[-1]['plain_ms']:.6f} ms (device, CUDA graph), bound "
            f"{bound_ms:.6f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
            f"bound; the wrapper takes {shapes[-1]['host_ms']:.6f} ms of "
            "host time per call")

    for what, (arrays, c, h, w) in splat_cases(rng, splat.TILE_H,
                                               splat.TILE_W).items():
        got = check([torch.from_numpy(a).to(DEVICE) for a in arrays], c, h,
                    w, what)
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

    total = {k: sum(s[k] for s in shapes)
             for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[kernel] per train step: kernel {total['ms']:.6f} ms, bound "
        f"{total['bound_ms']:.6f} ms, {total['bound_ms'] / total['ms']:.1%} "
        "of the bound")
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


def phase_serve() -> None:
    import torch

    from monocon_tpu_torch import create_detector, decode_predictions
    from monocon_tpu_torch.ops.decode import DEFAULT_P2
    from monocon_tpu_torch.ops.heatmap import local_maximum, topk_from_heatmap

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
        heat, inds, labels, _, _ = topk_from_heatmap(
            local_maximum(pred["center_heatmap_pred"]), k=30)
        # (cell, class) -> (rank, heatmap peak) of each decoded detection.
        keys = {(int(i), int(c)): (j, float(s)) for j, (s, i, c) in
                enumerate(zip(heat[0].cpu(), inds[0].cpu(), labels[0].cpu()))}
        outs[device] = ({k: v.cpu() for k, v in pred.items()},
                        {k: v.cpu() for k, v in dec.items()}, keys)
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

    # The decoded top-30 as sets keyed by (cell, class): a detection whose
    # CPU peak clears the 30th by more than twice the card/CPU heatmap
    # difference must be found on the card, with the same boxes and score;
    # the others may trade places with ties at the 30th.
    kth = min(s for _, s in k_c.values())
    matched = 0
    for cell, (jc, peak) in k_c.items():
        if cell not in k_g:
            if peak - kth > 2 * heat_err:
                raise AssertionError(f"serve: detection {cell} (peak {peak})"
                                     " missing on the card")
            continue
        jg, _ = k_g[cell]
        for field in ("bboxes_2d", "bboxes_3d", "scores"):
            a, b = dec_g[field][0, jg], dec_c[field][0, jc]
            if not torch.allclose(a, b, rtol=1e-3, atol=1e-3):
                raise AssertionError(f"serve: {field} of {cell}: {a} vs {b}")
        matched += 1
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = phase_environment()
    phase_build()
    rng = np.random.default_rng(SEED)
    entry = phase_kernel(rng)
    phase_serve()
    entry["launches"] = phase_train()
    print(card, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
