"""Readings of the numbers compared, for setting their limits: the
program's first three steps against the reference on each seed, and the
control (the reference in the precision below the configuration's: TF32
for float32) and the planted faults (``check.FAULTS``) against the
reference, in one process, without a measured window.

    python3 perfbench/calibrate.py --workload dla102-f32.train-step \\
        --seeds 1 2 3 --control 1 2 3 --out chiprun_out/cal.jsonl

One JSON line a seed: ``seed``, the program's numbers and, for the
seeds in ``--control``, the control's (``tf32_*``) and each fault's
(``half_*``, ``conv2_*``), each against the reference.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", type=int, nargs="*", default=[])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    from perfbench import run
    from perfbench.check import FAULTS, train_check
    from perfbench.drivers import KINDS

    spec = run.cell_spec(args.workload)
    run.set_caches()
    import torch

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run.program_backends(spec["config"])
    config, traffic = spec["config"], spec["traffic"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = KINDS[traffic["kind"]](args.workload, config, traffic, seed,
                                      device)
        cell.setup()
        control = (",".join([config["control"], *FAULTS])
                   if seed in args.control else None)
        record = cell.record
        cell.free()
        numbers = train_check(record, config, traffic.get("augment", True),
                              device, control)
        numbers.update(seed=seed, seconds=time.perf_counter() - t0,
                       card=run.card_label())
        line = json.dumps(numbers)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del cell, record
    return 0


if __name__ == "__main__":
    sys.exit(main())
