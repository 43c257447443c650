"""The benchmark of ``monocon_tpu_torch`` on one NVIDIA card.

    python3 perfbench/run.py --workload dla34-f32.train-step --seed 7 \\
        --seconds 30 --trace 0

Finds the cell in ``BENCHMARK.json``, its configuration in
``perfbench/configs/<config>.json``, its traffic in
``perfbench/traffic/<traffic>.json`` and each per-layer metric's reader in
``perfbench/metrics/<metric>.py``; sets up (the synthetic KITTI tree,
written once under ``perfbench/cache/``, the engine, weights from the
seed on the card, the first three steps, which the check replays),
measures for ``--seconds``, checks the first steps against the plain
reference in ``perfbench/reference/`` and prints one JSON line last.
``--trace 1`` profiles a stretch of the window and prints the per-layer
metrics instead of the end-to-end ones. No card, fewer cards than the
cell asks for, or a module of JAX or of the JAX package loaded by the
end of the window: no result and a nonzero exit.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "monocon_tpu")
GIB = 2 ** 30


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_spec(workload: str, root: Path = ROOT) -> Dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(root / "perfbench" / "traffic"
                        / f"{cell['traffic']}.json")
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"]
                           if applies(m, workload)],
            "per_layer": [m for m in bench["per_layer"]
                          if applies(m, workload)]}


def reader(name: str, root: Path = ROOT):
    """The ``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = HERE / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def program_backends(config: Dict) -> None:
    """The program's float32 as the configurations state it: TF32 off in
    convolutions and matrix products, cuDNN's autotuning as ``cfg``'s
    ``USE_BENCHMARK`` says (the engine picks its memory format by it)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = bool(
        config["cfg"].get("USE_BENCHMARK", True))


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def end_to_end(spec: Dict, window: Dict, setup_s: float) -> Dict:
    values = {
        "setup_s": setup_s,
        "train_images_per_s": window["images"] / window["wall"],
        "train_peak_mem_gib": window["memory_peak_bytes"] / GIB,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec["end_to_end"]}


def per_layer(spec: Dict, ctx: Dict, root: Path = ROOT) -> Dict:
    """Each per-layer metric its reader finds something to read for."""
    out = {}
    for m in spec["per_layer"]:
        value = reader(m["name"], root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, device,
             cache: Optional[Path] = None) -> Tuple[Dict, Dict]:
    """Set up, measure and check one run; (result line, numbers)."""
    import torch

    from . import trace as tr
    from .check import train_check, verdict
    from .drivers import KINDS

    config, traffic = spec["config"], spec["traffic"]
    kind = traffic["kind"]
    cell = KINDS[kind](spec["cell"]["name"], config, traffic, seed, device,
                       **({} if cache is None else {"cache": cache}))
    cell.setup()
    setup_s = time.perf_counter() - T0
    window = cell.window(seconds, trace)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: "
                         f"{', '.join(found)}")
    kind_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else device.type)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind_name, "count": int(spec["cell"]["chips"]),
           "memory_peak_bytes": window["memory_peak_bytes"]}
    result = {"correct": False, "attempted": window["images"], "failed": 0}
    traced = cell.profiled.trace if cell.profiled is not None else None
    if trace:
        ctx = {"kind": kind, "window": window, "counters": cell.counters,
               "trace": traced, "device_name": kind_name,
               "dtype": cell.dtype, "pad_hw": cell.pad_hw,
               "batch": cell.batch, "config": config}
        result["metrics"] = per_layer(spec, ctx)
        if traced is not None:
            dev.update(busy_s=tr.busy_seconds(traced), window_s=traced.wall)
    else:
        result["metrics"] = end_to_end(spec, window, setup_s)
    result["device"] = dev
    if traced is not None:
        result["breakdown"] = tr.breakdown(traced)
    record = cell.record
    cell.free()
    numbers = train_check(record, config, traffic.get("augment", True),
                          device)
    ok, checks = verdict(numbers, config["limits"])
    result["correct"] = ok
    result["checks"] = checks
    return result, numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = cell_spec(args.workload)
    set_caches()
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    program_backends(spec["config"])
    result, numbers = run_cell(spec, args.seed, args.seconds,
                               bool(args.trace), device)
    print(f"card: {card_label()}", file=sys.stderr)
    print("readings: " + json.dumps(numbers), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        # Run as a script: import this file's package under its name.
        __package__ = "perfbench"
        import perfbench  # noqa: F401
    sys.exit(main())
