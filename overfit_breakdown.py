#!/usr/bin/env python3
"""Where the overfit check's bfloat16 run falls behind float32.

    python3 overfit_breakdown.py [--steps 4000 ...] [--hw 192x640 ...]
        [--dtype bfloat16 float32] [--repeat 1] [--every 100] [--jobs 1]
        [--init STATE_DICT] [--root TREE] [--device cpu] [--out FILE]

Runs the loop of ``monocon_tpu_torch.checks.overfit.run_overfit`` (the
check's tree written at each canvas, one batch of 4, DLA-34 from seed 0,
the one-cycle AdamW at LR 5e-4) once for every steps x canvas x dtype
given. Every ``--every`` steps, and at the last, it prints one JSON line
of the step: the center-heatmap and total losses (taken before the
step's update, as the check's are), over the objects' rows (mask 1) the
share of rows with a predicted dimension below 0 (``neg_dim_rows``), the
share of their dimension entries below 0 (``neg_dims``) and the smallest
entry (``min_dim``), and the gradient's global norm before the clip at
35 (``grad_norm``). Each run ends with a line of the check's result: the
last step's heatmap loss, the nonzero AP entries, detections per image,
ms/step, the rule and the splat kernel's launches (2 a step on the
card, 0 on the CPU, where the wrapper runs the plain version). The last line is a JSON object of every run's
result.

``--repeat N`` runs each combination N times (the card's
non-deterministic kernels part their trajectories), named ``#1``...
``--jobs N`` runs N of the runs at once, each in a process of its own on
the same device: their ms/step are then no timing. ``--init`` starts
every run from a saved ``state_dict`` (e.g. the JAX package's initial
weights, converted) instead of the detector from seed 0, and ``--root``
reads a tree of the check's layout (e.g. the JAX package's generator's)
instead of writing the check's. With no ``--device`` the runs take the
card. Prints the device's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

EVERY = 100


def breakdown_run(steps: int, dtype: str, image_hw: Tuple[int, int],
                  device: torch.device, every: int = EVERY,
                  model: Optional[torch.nn.Module] = None,
                  emit: Callable[[str], None] = print,
                  root: Optional[str] = None, tag: str = "") -> dict:
    """One overfit run of ``steps`` steps at ``image_hw``, logged every
    ``every`` steps through ``emit`` (see the module docstring). ``model``
    replaces the detector from seed 0, as in ``run_overfit``; ``root``
    names a tree to read (e.g. the JAX package's generator's) instead of
    the check's tree written anew; ``tag`` ends the run's name. Returns
    the run's result line."""
    from monocon_tpu_torch.checks.overfit import (overfit_batch, run_overfit,
                                                  write_tree)
    from monocon_tpu_torch.engine.train_step import FEAT_STRIDE
    from monocon_tpu_torch.models.detector import create_detector
    from monocon_tpu_torch.ops import splat
    from monocon_tpu_torch.ops.heatmap import gather_feature
    from monocon_tpu_torch.ops.targets import generate_targets

    run = f"{dtype} {image_hw[0]}x{image_hw[1]} {steps}{tag}"
    if model is None:
        model = create_detector(
            generator=torch.Generator().manual_seed(0), device=device,
            compute_dtype=(torch.bfloat16 if dtype == "bfloat16"
                           else torch.float32))
    # The train forward's dimension map, read at the objects' rows.
    seen: Dict[str, torch.Tensor] = {}
    handle = model.register_forward_hook(
        lambda module, args, out: seen.__setitem__(
            "dim", out["dim_pred"].detach()))
    with contextlib.ExitStack() as stack:
        if root is None:
            root = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="overfit_"))
            write_tree(root, image_hw)
        _, _, batch = overfit_batch(root, device, image_hw)
        feat_hw = (image_hw[0] // FEAT_STRIDE, image_hw[1] // FEAT_STRIDE)
        with torch.no_grad():
            target = generate_targets(batch["label"], feat_hw, image_hw)
        indices, objects = target["indices"], target["mask_target"] > 0
        del batch

        def on_step(i, losses, solver) -> None:
            if i % every and i != steps - 1:
                return
            dims = gather_feature(seen["dim"], indices)[objects]   # (n, 3)
            emit(json.dumps({
                "run": run, "step": i,
                "loss_center_heatmap": float(losses["loss_center_heatmap"]),
                "total_loss": float(losses["total_loss"]),
                "neg_dim_rows": float((dims < 0).any(-1).float().mean()),
                "neg_dims": float((dims < 0).float().mean()),
                "min_dim": float(dims.min()),
                "grad_norm": float(solver.grad_norm)}))

        splat.launch_count = 0
        try:
            result = run_overfit(root, steps, dtype=dtype, device=device,
                                 image_hw=image_hw, model=model,
                                 on_step=on_step)
        finally:
            handle.remove()
        launches = splat.launch_count
    line = {"run": run, "result": {
        "loss_center_heatmap": result["final"]["loss_center_heatmap"],
        "total_loss": result["final"]["total_loss"],
        "nonzero_ap": len(result["nonzero_ap"]),
        "detections": result["detections"],
        "ms_per_step": result["ms_per_step"], "passed": result["passed"],
        "splat_launches": launches}}
    emit(json.dumps(line))
    return line


def initial_model(path: Optional[str], dtype: str,
                  device: torch.device) -> Optional[torch.nn.Module]:
    """The detector with the ``state_dict`` saved at ``path`` (None: the
    run's own from seed 0)."""
    if path is None:
        return None
    from monocon_tpu_torch.models.detector import create_detector

    model = create_detector(device=device, compute_dtype=(
        torch.bfloat16 if dtype == "bfloat16" else torch.float32))
    model.load_state_dict(torch.load(path, map_location=device))
    return model


def parse_hw(text: str) -> Tuple[int, int]:
    h, w = text.lower().split("x")
    return int(h), int(w)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, nargs="+", default=[4000])
    parser.add_argument("--hw", type=parse_hw, nargs="+",
                        default=[(192, 640)], help="canvases, as HxW")
    parser.add_argument("--dtype", nargs="+",
                        default=["bfloat16", "float32"],
                        choices=("float32", "bfloat16"))
    parser.add_argument("--repeat", type=int, default=1)
    parser.add_argument("--tag", default="", help=argparse.SUPPRESS)
    parser.add_argument("--every", type=int, default=EVERY)
    parser.add_argument("--jobs", type=int, default=1)
    parser.add_argument("--device", default=None,
                        help="run on this device instead of the card")
    parser.add_argument("--init", default=None,
                        help="a saved state_dict to start every run from")
    parser.add_argument("--root", default=None,
                        help="a tree to read instead of the check's")
    parser.add_argument("--out", default=None,
                        help="also write every JSON line to this file")
    args = parser.parse_args(argv)

    from monocon_tpu_torch.checks import device_label
    from monocon_tpu_torch.config import get_default_cfg
    from monocon_tpu_torch.device import resolve_device
    from monocon_tpu_torch.train import configure_backends

    device = resolve_device(args.device)
    configure_backends(get_default_cfg(), deterministic=False)
    runs = [(s, hw, d, f"#{k + 1}" if args.repeat > 1 else args.tag)
            for s in args.steps for hw in args.hw for d in args.dtype
            for k in range(args.repeat)]
    lines: List[str] = []

    def emit(line: str) -> None:
        lines.append(line)
        print(line, flush=True)

    print(f"device: {device_label(device)}", flush=True)
    results = []
    if args.jobs <= 1 or len(runs) == 1:
        for steps, hw, dtype, tag in runs:
            results.append(breakdown_run(
                steps, dtype, hw, device, args.every,
                initial_model(args.init, dtype, device), emit, args.root,
                tag))
    else:
        shared = [*(["--init", args.init] if args.init else []),
                  *(["--root", args.root] if args.root else [])]
        for start in range(0, len(runs), args.jobs):
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--steps", str(steps), "--hw",
                 f"{hw[0]}x{hw[1]}", "--dtype", dtype, "--every",
                 str(args.every), "--device", str(device), "--tag", tag,
                 *shared], stdout=subprocess.PIPE, text=True)
                for steps, hw, dtype, tag in runs[start:start + args.jobs]]
            for proc in procs:
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    print(out, flush=True)
                    return proc.returncode
                for text in out.splitlines():
                    if text.startswith("{\"run\""):
                        emit(text)
                results += [{"run": run, "result": result} for run, result
                            in json.loads(out.splitlines()[-1]).items()]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(lines) + "\n")
    print(json.dumps({r["run"]: r["result"] for r in results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
