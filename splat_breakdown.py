#!/usr/bin/env python3
"""Where the splat kernel's time goes, on one NVIDIA GPU.

    python3 splat_breakdown.py [--against DIR]

On the two splat calls of one 384x1280 train batch (B=8, feature map
96x320: center C=3 N=30, keypoint C=9 N=270) it checks the kernel against
the plain version and times, by CUDA-graph replay, each through
``splat_max_heatmap_cuda``:

- ``ms``: the call itself;
- ``n0_ms``: the same call with N=0, the launch and the stores alone;
- ``invalid_ms``: every instance invalid, which adds the cull with
  nothing to evaluate;
- ``fill_ms``: ``fill_`` of an output of the same size, the card's floor
  for writing those bytes in one PyTorch call.

With ``--against DIR``, the root of another checkout of the repo with the
same C interface (an earlier commit unpacked with ``git archive`` into a
git-ignored directory), it also runs that checkout's kernel, through its
own wrapper and build, on the same two calls and on ``chip_smoke``'s
dense random and edge cases, and fails unless the two kernels' outputs are
equal bit for bit.

Prints the card's name and power limit, then one JSON object per call and
per compared case. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

import chip_smoke as smoke


def splat_module_of(root: Path):
    """``monocon_tpu_torch/ops/splat.py`` of the checkout at ``root``,
    imported under a name of its own."""
    path = root / "monocon_tpu_torch" / "ops" / "splat.py"
    spec = importlib.util.spec_from_file_location("splat_against", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    import torch

    from monocon_tpu_torch.ops import splat

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, default=None,
                        help="root of another checkout whose kernel must "
                             "give the same bits")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("splat_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(smoke.gpu_name_and_power(), flush=True)
    batch = smoke.train_batch(np.random.default_rng(smoke.SEED + 1),
                              smoke.TRAIN_BATCH, smoke.PAD_HW, smoke.DEVICE)
    _, calls = smoke.capture_splat_inputs(batch, smoke.FEAT_HW, smoke.PAD_HW)
    per_step = 0.0
    for name, (*args, c, h, w) in zip(("center", "keypoint"), calls):
        b = args[1].shape[0]
        got = splat.splat_max_heatmap_cuda(*args, c, h, w)
        err = float((got - splat.splat_max_heatmap_plain(*args, c, h, w))
                    .abs().max())
        if not err <= smoke.SPLAT_TOL:
            raise AssertionError(f"{name}: error {err}")
        empty = [a[:, :0].contiguous() for a in args]
        invalid = [*args[:3], torch.zeros_like(args[3])]

        def timed(inputs):
            return smoke.graph_ms(
                lambda: splat.splat_max_heatmap_cuda(*inputs, c, h, w), 50)

        def fill():
            torch.empty((b, c, h, w), dtype=torch.float32,
                        device=smoke.DEVICE).fill_(0.5)

        bound_ms, bound_by = smoke.splat_bound_ms(args, c, h, w)
        row = {"call": name, "ms": timed(args), "n0_ms": timed(empty),
               "invalid_ms": timed(invalid),
               "fill_ms": smoke.graph_ms(fill, 50), "bound_ms": bound_ms,
               "bound_by": bound_by, "max_abs_err": err}
        per_step += row["ms"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"ms_per_step": per_step}), flush=True)

    if opts.against is None:
        return 0
    other = splat_module_of(opts.against.resolve())
    cases = {f"main path, {name}": (args, c, h, w)
             for name, (*args, c, h, w) in zip(("center", "keypoint"), calls)}
    for what, (arrays, c, h, w) in smoke.splat_cases(
            np.random.default_rng(smoke.SEED), splat.TILE_H,
            splat.TILE_W).items():
        cases[what] = ([torch.from_numpy(a).to(smoke.DEVICE) for a in arrays],
                       c, h, w)
    differ = []
    for what, (args, c, h, w) in cases.items():
        mine = splat.splat_max_heatmap_cuda(*args, c, h, w)
        theirs = other.splat_max_heatmap_cuda(*args, c, h, w)
        equal = torch.equal(mine.view(torch.int32), theirs.view(torch.int32))
        diff = float((mine - theirs).abs().max()) if mine.numel() else 0.0
        print(json.dumps({"case": what, "bit_equal": equal,
                          "max_abs_diff": diff}), flush=True)
        if not equal:
            differ.append(what)
    if differ:
        raise AssertionError(f"the kernels differ from {opts.against} on "
                             f"{differ}")
    print(json.dumps({"against": str(opts.against), "bit_equal_cases":
                      len(cases)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
