"""Benchmark of the port's main path: frames/s of KITTI-val inference at
384x1280, DLA forward + full 3D decode, on one card.

    python -m monocon_tpu_torch.bench            # on the card
    python -m monocon_tpu_torch.bench --device cpu

Port of the root ``bench.py``, with its environment variables:
``BENCH_BATCH`` (128), ``BENCH_ITERS`` (20), ``BENCH_DTYPE`` (bfloat16,
by autocast as the port's bf16 path runs; or float32) and ``BENCH_DLA``
(34). Three warmup calls, then the best of three windows, each chaining a
score sum through every iteration and reading it on the host once at the
end. TF32 is off, so that float32 computes in float32.

Prints one JSON line with ``bench.py``'s keys, and the device it ran on:
``device_ms_per_step`` is the summed GPU kernel time per iteration of one
more window under ``torch.profiler`` (:func:`device_op_seconds`);
``mfu_pct`` divides the FLOPs that ``torch.utils.flop_counter`` counts
over one forward + decode by that time and the card's dense peak.
``vs_baseline`` and ``torch_fps`` are null: the reference checkout that
``bench.py`` times on the CPU is not part of this repository. On the CPU
there is no device time and no peak, so the device keys are null. A
failing profiler raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

PAD_HW = (384, 1280)
WARMUP = 3
WINDOWS = 3
# Dense peak FLOP/s per card name (torch.cuda.get_device_name), from
# NVIDIA's H100 Tensor Core GPU data sheet, SXM5 part: 989.4 TFLOP/s
# bf16 on the tensor cores, 66.9 TFLOP/s float32 outside them (TF32 is
# off), at the full 700 W.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}


def settings() -> Dict[str, object]:
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    if dtype not in ("bfloat16", "float32"):
        raise ValueError(f"BENCH_DTYPE={dtype}: bfloat16 or float32")
    return {"batch": int(os.environ.get("BENCH_BATCH", "128")),
            "iters": int(os.environ.get("BENCH_ITERS", "20")),
            "dtype": dtype,
            "dla": int(os.environ.get("BENCH_DLA", "34"))}


def make_forward(num_layers: int, dtype: str, batch: int,
                 device: torch.device, pad_hw=PAD_HW):
    """(model, forward, image, p2): DLA-``num_layers`` with weights from
    seed 0, eval mode, and a random normalised (batch, H, W, 3) image with
    the default P2; ``forward(image, p2)`` runs the forward and the
    decode."""
    from .models.detector import create_detector
    from .ops.decode import DEFAULT_P2, decode_predictions

    model = create_detector(
        num_layers, generator=torch.Generator().manual_seed(0),
        device=device,
        compute_dtype=getattr(torch, dtype)).eval()

    @torch.no_grad()
    def forward(image, p2):
        return decode_predictions(model(image), p2, pad_hw)

    rng = np.random.default_rng(0)
    image = torch.from_numpy(
        rng.normal(size=(batch, *pad_hw, 3)).astype(np.float32)).to(device)
    p2 = torch.from_numpy(np.tile(DEFAULT_P2[None], (batch, 1, 1))).to(device)
    return model, forward, image, p2


def count_flops(forward: Callable, *args) -> int:
    """FLOPs of one ``forward(*args)`` as ``torch.utils.flop_counter``
    counts them: 2 per multiply-add of the convolutions, transposed
    convolutions and matrix products."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        forward(*args)
    return counter.get_total_flops()


def _window(forward, image, p2, iters: int) -> float:
    """Seconds of ``iters`` calls with the scores' sum chained through
    them and read once at the end."""
    t0 = time.perf_counter()
    acc = torch.zeros((), device=image.device)
    for _ in range(iters):
        acc = acc + forward(image, p2)["scores"].sum()
    float(acc)
    return time.perf_counter() - t0


def run(device: torch.device, batch: int, iters: int, dtype: str,
        dla: int) -> Dict[str, Optional[float]]:
    from .utils.profiling import device_op_seconds, device_trace

    _, forward, image, p2 = make_forward(dla, dtype, batch, device)
    for _ in range(WARMUP):
        out = forward(image, p2)
    float(out["scores"].sum())
    fps = max(batch * iters / _window(forward, image, p2, iters)
              for _ in range(WINDOWS))

    device_ms = mfu_pct = None
    if device.type == "cuda":
        with tempfile.TemporaryDirectory() as log_dir:
            with device_trace(log_dir):
                _window(forward, image, p2, iters)
            kernel_s = device_op_seconds(log_dir)
        if kernel_s <= 0:
            raise RuntimeError("the profiler's trace holds no GPU kernel")
        device_ms = kernel_s / iters * 1e3
        name = torch.cuda.get_device_name(device)
        peak = PEAK_FLOPS.get(name, {}).get(dtype)
        if peak is None:
            print(f"bench: no peak FLOP/s known for {name!r} in {dtype}; "
                  "mfu_pct is null", file=sys.stderr)
        else:
            flops = count_flops(forward, image, p2)
            mfu_pct = 100.0 * flops / (device_ms / 1e3) / peak
    return {"fps": fps, "device_ms": device_ms, "mfu_pct": mfu_pct}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="frames/s of the port's "
                                     "forward + 3D decode at 384x1280")
    parser.add_argument("--device", type=str, default=None,
                        help="run on this device instead, e.g. cpu")
    args = parser.parse_args(argv)

    from .device import resolve_device

    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = settings()
    result = run(device, cfg["batch"], cfg["iters"], cfg["dtype"],
                 cfg["dla"])
    device_ms = result["device_ms"]
    print(json.dumps({
        "metric": "frames/sec/chip on KITTI val (384x1280) inference "
                  f"(DLA-{cfg['dla']} forward + 3D decode)",
        "value": result["fps"],
        "unit": "frames/sec/chip",
        "vs_baseline": None,
        "torch_fps": None,
        "device_ms_per_step": device_ms,
        "device_fps": (cfg["batch"] / (device_ms / 1e3)
                       if device_ms else None),
        "mfu_pct": result["mfu_pct"],
        "batch": cfg["batch"],
        "dtype": cfg["dtype"],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
