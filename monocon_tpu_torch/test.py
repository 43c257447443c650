"""Evaluate or visualize a MonoCon checkpoint on KITTI with the port, on
the card.

    python -m monocon_tpu_torch.test --checkpoint_file model.pth \\
        --data_root /data/kitti --evaluate --visualize --save_dir vis

The flags of the root ``test.py``: --config_file, --checkpoint_file (a
reference-format ``.pth``; an Orbax directory of the JAX package must be
exported first with ``scripts/export_torch_ckpt.py``), --data_root,
--gpu_id (runs on ``cuda:<gpu_id>``), --evaluate, --visualize, --save_dir.
``--device`` names another device, e.g. ``cpu``; without it and without a
card the command fails. ``--visualize`` writes one PNG per test image
and item under ``--save_dir``: ``2d/``, ``3d/`` and ``bev/``, each named
as its image (``MonoConEngine.visualize``). ``--set KEY VALUE`` sets a
config key, as in the train CLI.

As the train CLI does, it runs one process per GPU under torchrun or when
``TPU.NUM_DEVICES`` asks for several (-1, the default, is every visible
GPU): each rank evaluates its rows of every batch and rank 0 computes the
AP dict and draws. With ``--set TPU.SPATIAL_SHARDS S`` the ranks form
data shards of ``S`` bands of the canvas height each (a static
``TPU.PAD_HW``), as in the train CLI.
"""

from __future__ import annotations

import argparse
import sys

import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MonoCon evaluation "
                                     "(PyTorch port)")
    parser.add_argument("--config_file", type=str, default=None)
    parser.add_argument("--checkpoint_file", type=str, required=True,
                        help="reference-format .pth")
    parser.add_argument("--data_root", type=str, default=None)
    parser.add_argument("--gpu_id", type=int, default=0,
                        help="the card to run on, cuda:<gpu_id>")
    parser.add_argument("--device", type=str, default=None,
                        help="run on this device instead, e.g. cpu")
    parser.add_argument("--evaluate", action="store_true")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--save_dir", type=str, default="./vis_results")
    parser.add_argument("--set", nargs=2, action="append", default=[],
                        metavar=("KEY", "VALUE"),
                        help="set a config key, e.g. --set TPU.NUM_DEVICES 1")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from .config import get_default_cfg, load_cfg
    from .device import resolve_device
    from .parallel import launch
    from .train import set_key

    if args.device is not None:
        device = torch.device(args.device)
    else:
        resolve_device()  # raises without a card
        device = torch.device("cuda", args.gpu_id)
    cfg = load_cfg(args.config_file) if args.config_file else get_default_cfg()
    if args.data_root:
        cfg.DATA.ROOT = args.data_root
    for key, text in args.set:
        set_key(cfg, key, text)
    launch(run_test, cfg, device, args)
    return 0


def run_test(cfg, device: torch.device, args) -> None:
    """Evaluate and draw on ``device``, as one process or one rank."""
    from .engine.engine import MonoConEngine

    # The test CLI leaves cuDNN's heuristics on (no autotuning).
    engine = MonoConEngine(cfg, is_test=True, device=device, autotune=False)
    engine.load_checkpoint(args.checkpoint_file)
    if engine.is_main:
        print(f"Checkpoint '{args.checkpoint_file}' loaded.", flush=True)
    if args.evaluate:
        engine.evaluate()
    if args.visualize:
        engine.visualize(args.save_dir, draw_items=["2d", "3d", "bev"])
        if engine.is_main:
            print(f"Visualizations saved to '{args.save_dir}'.", flush=True)


if __name__ == "__main__":
    sys.exit(main())
