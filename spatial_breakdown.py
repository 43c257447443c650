#!/usr/bin/env python3
"""The image height split over NVIDIA GPUs through NCCL, against one
process on one GPU.

    python3 spatial_breakdown.py [--layouts 2x1,1x2,4x1,1x4,2x2]

DLA-34 float32 (TF32 off) from ``chip_smoke``'s seed, on its B=8 train
batch at 384x1280 (uint8 images, random labels). First the plain
``train_step`` in this process on ``cuda:0``, ``chip_smoke.PARALLEL_STEPS``
steps, the first not timed. Then, for each layout ``D x S`` that the
visible GPUs hold, ``D x S`` processes, one a GPU, in an NCCL group:
rank ``r`` takes the rows of data shard ``r // S`` and band ``r % S`` of
their canvas (``parallel/mesh.py``) and runs the same steps under
``data_parallel``. The deployment of ``TPU.SPATIAL_SHARDS``, where
``chip_smoke.py`` phase 13 can only put two gloo ranks on one card; a
layout ``D x 1`` is plain data parallelism over ``D`` GPUs, which holds
the synced BatchNorm and DDP beside the bands. Then one more step of
the plain process and of each layout's rank 0 under ``torch.profiler``:
the card's busy share of its wall time and its top kernels
(``chip_smoke.kernel_breakdown``).

Prints the card's name and power limit, one JSON object per layout
(ms/step and peak memory of each rank, the largest difference of its
first losses from the plain step's, the splat launches of each rank,
rank 0's traced step) and as the last line one JSON object with the
plain step's numbers and every layout's. Fails if a loss is off by more than rtol 1e-3 / atol 1e-4, if
the ranks' parameters differ after the steps, or if the splat kernel did
not launch twice a step on every rank. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import tempfile
from pathlib import Path

import chip_smoke as smoke


def layout_worker(out_dir: str, spatial: int) -> None:
    """One rank of a layout (run by ``spawn_ranks``): its rows and band of
    the batch, the timed steps, a SHA-256 of its parameters' bytes."""
    import torch
    import torch.distributed as dist

    from monocon_tpu_torch import build_optimizer, create_detector, train_step
    from monocon_tpu_torch.parallel import (data_parallel,
                                            initialize_distributed,
                                            spatial_layout)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = initialize_distributed("cuda")
    try:
        layout = spatial_layout(smoke.PAD_HW[0], spatial)
        rows = smoke.rank_batch(device, layout.data_index,
                                layout.data_shards)
        start, stop = layout.band
        batch = {"img": rows["img"][:, start:stop], "label": rows["label"]}
        model = create_detector(
            34, generator=torch.Generator().manual_seed(smoke.SEED),
            device=device)
        wrapped = data_parallel(model, device)
        run = smoke.timed_train_steps(wrapped, smoke.PARALLEL_STEPS, batch,
                                      device, layout)
        digest = hashlib.sha256()
        for p in model.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
        run.update(params_sha256=digest.hexdigest(), band=[start, stop],
                   rows=len(rows["img"]))
        rank = dist.get_rank()
        optimizer, solver = build_optimizer(wrapped.parameters(),
                                            total_steps=1)

        def step():
            train_step(wrapped, optimizer, solver, batch, layout)

        if rank == 0:
            run["trace"] = smoke.kernel_breakdown(step, top=8)
        else:
            step()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(run))
    finally:
        dist.destroy_process_group()


def plain_step() -> dict:
    """The one-process step on ``cuda:0``."""
    import torch

    from monocon_tpu_torch import build_optimizer, create_detector, train_step

    device = torch.device("cuda", 0)
    model = create_detector(
        34, generator=torch.Generator().manual_seed(smoke.SEED),
        device=device)
    batch = smoke.rank_batch(device, 0, 1)
    run = smoke.timed_train_steps(model, smoke.PARALLEL_STEPS, batch, device)
    optimizer, solver = build_optimizer(model.parameters(), total_steps=1)
    run["trace"] = smoke.kernel_breakdown(
        lambda: train_step(model, optimizer, solver, batch), top=8)
    del model, optimizer, solver
    gc.collect()
    torch.cuda.empty_cache()
    return run


def main() -> int:
    import torch

    from monocon_tpu_torch.parallel import spawn_ranks

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--layouts", default="2x1,1x2,4x1,1x4,2x2",
                        help="data shards x bands, comma-separated")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("spatial_breakdown: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.gpu_name_and_power()
    visible = torch.cuda.device_count()
    print(f"{card}, {visible} visible", flush=True)
    plain = plain_step()
    summary = {"plain": {k: plain[k] for k in ("ms", "peak", "launches",
                                               "trace")},
               "layouts": {}}
    print(json.dumps({"layout": "plain", **summary["plain"]}), flush=True)
    for name in args.layouts.split(","):
        shards, spatial = (int(v) for v in name.split("x"))
        world = shards * spatial
        if world > visible:
            print(f"{name}: {world} GPUs needed, {visible} visible; "
                  "skipped", flush=True)
            continue
        with tempfile.TemporaryDirectory() as out:
            spawn_ranks(world, layout_worker, out, spatial)
            runs = [json.loads((Path(out) / f"rank{r}.json").read_text())
                    for r in range(world)]
        if len({r["params_sha256"] for r in runs}) != 1:
            raise AssertionError(f"{name}: the ranks' parameters differ")
        worst = max(smoke.same_losses(r["losses"], plain["losses"], name)
                    for r in runs)
        if any(r["launches"] != 2 * smoke.PARALLEL_STEPS for r in runs):
            raise AssertionError(f"{name}: splat launches "
                                 f"{[r['launches'] for r in runs]}")
        line = {"layout": name, "ms": [r["ms"] for r in runs],
                "peak": [r["peak"] for r in runs],
                "bands": [r["band"] for r in runs],
                "rows": [r["rows"] for r in runs],
                "launches": [r["launches"] for r in runs],
                "max_loss_diff": worst, "trace_rank0": runs[0]["trace"]}
        print(json.dumps(line), flush=True)
        summary["layouts"][name] = line
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
