"""Train MonoCon on KITTI with the port, on the card.

    python -m monocon_tpu_torch.train --data_root /data/kitti \\
        --output_dir outputs/run1

The flags of the root ``train.py``: --config_file (a YAML overlay such as
``configs/kitti_v5e.yaml``, read without PyYAML), --data_root,
--output_dir, --num_epochs, --batch_size. Besides them: --set KEY VALUE
(repeatable) sets one config key after the file, e.g. ``--set
TPU.GRAD_ACCUM_STEPS 2``; --deterministic
makes cuDNN and the other CUDA ops pick deterministic algorithms, so that
two runs give the same bits; --resume_from continues the run of a
checkpoint directory; --gpu_id runs on ``cuda:<gpu_id>``; --device
names another device, e.g. ``cpu``. Without --device and without a card
the command fails.

Several GPUs: ``TPU.NUM_DEVICES`` (-1, the default, is every visible GPU)
starts one process per GPU, or a launcher does, on one node or several:

    torchrun --nproc_per_node 8 -m monocon_tpu_torch.train ...

``DATA.BATCH_SIZE`` is the global batch, split over the processes
(``engine/engine.py``, ``parallel/distributed.py``); process ``r`` of a
node runs on ``cuda:r``, whatever --gpu_id says. On the CPU,
``--device cpu --set TPU.NUM_DEVICES 2`` runs two gloo processes.

The image height split over ranks: ``--set TPU.SPATIAL_SHARDS S`` (and a
static ``TPU.PAD_HW``) makes the processes ``D`` data shards of ``S``
bands each, rank ``r`` holding band ``r % S`` of shard ``r // S``; e.g.
``--device cpu --set TPU.NUM_DEVICES 4 --set TPU.SPATIAL_SHARDS 2`` runs
2 x 2 gloo processes, and ``torchrun --nproc_per_node 8`` with
``SPATIAL_SHARDS 2`` runs 4 x 2 on eight GPUs.

As the root ``train.py`` does: SEED -1 draws a random seed (rank 0's, for
every rank), and an existing complete checkpoint under OUTPUT_DIR is
resumed. TF32 is off, so that the card computes in float32 as the CPU
does; cuDNN autotunes its convolutions when USE_BENCHMARK is true and
--deterministic is not given.
"""

from __future__ import annotations

import argparse
import ast
import os
import random
import sys

import torch
import torch.distributed as dist

# cuBLAS reads it when it creates its first handle; deterministic matrix
# products need it.
CUBLAS_WORKSPACE = ":4096:8"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="MonoCon training "
                                     "(PyTorch port)")
    parser.add_argument("--config_file", type=str, default=None,
                        help="optional YAML config overlay")
    parser.add_argument("--data_root", type=str, default=None,
                        help="KITTI root (overrides DATA.ROOT)")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="output directory (overrides OUTPUT_DIR)")
    parser.add_argument("--num_epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--set", nargs=2, action="append", default=[],
                        metavar=("KEY", "VALUE"),
                        help="set a config key, e.g. --set SEED 0")
    parser.add_argument("--deterministic", action="store_true",
                        help="deterministic CUDA algorithms only")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="a checkpoint directory whose run to continue")
    parser.add_argument("--gpu_id", type=int, default=0,
                        help="the card to run on, cuda:<gpu_id>")
    parser.add_argument("--device", type=str, default=None,
                        help="run on this device instead, e.g. cpu")
    return parser.parse_args(argv)


def set_key(cfg, key: str, text: str) -> None:
    """``cfg[key] = text`` read as a Python literal (a string otherwise);
    ``key`` is dotted and must exist."""
    *path, leaf = key.split(".")
    node = cfg
    for part in path:
        node = node[part]
    if leaf not in node:
        raise KeyError(f"--set {key}: no such config key")
    try:
        value = ast.literal_eval(text)
    except (ValueError, SyntaxError):
        value = text
    node[leaf] = value


def main(argv=None) -> int:
    args = parse_args(argv)

    from .config import get_default_cfg, load_cfg
    from .device import resolve_device
    from .parallel import launch

    if args.device is not None:
        device = torch.device(args.device)
    else:
        resolve_device()  # raises without a card
        device = torch.device("cuda", args.gpu_id)
    cfg = load_cfg(args.config_file) if args.config_file else get_default_cfg()
    if args.data_root:
        cfg.DATA.ROOT = args.data_root
    if args.output_dir:
        cfg.OUTPUT_DIR = args.output_dir
    if args.num_epochs:
        cfg.SOLVER.OPTIM.NUM_EPOCHS = args.num_epochs
    if args.batch_size:
        cfg.DATA.BATCH_SIZE = args.batch_size
    for key, text in args.set:
        set_key(cfg, key, text)
    launch(run_training, cfg, device, args.deterministic, args.resume_from)
    return 0


def run_training(cfg, device: torch.device, deterministic: bool,
                 resume_from=None) -> None:
    """Train on ``device``, as one process or one rank of a group."""
    from .engine.engine import MonoConEngine
    from .utils.logging_utils import tprint

    # Random seed resolution (reference train.py:31-36), rank 0's for all.
    seed = [random.randint(0, 2**31 - 1) if cfg.SEED == -1 else cfg.SEED]
    if dist.is_initialized():
        dist.broadcast_object_list(seed, src=0)
    cfg.SEED = seed[0]
    if not dist.is_initialized() or dist.get_rank() == 0:
        tprint(f"Using random seed {cfg.SEED}.")

    autotune = configure_backends(cfg, deterministic)
    MonoConEngine(cfg, device=device, autotune=autotune).train(
        resume_from=resume_from)


def configure_backends(cfg, deterministic: bool) -> bool:
    """The CUDA settings of a training run: TF32 off; deterministic
    algorithms, or cuDNN's autotuning as ``cfg.USE_BENCHMARK`` says.
    Returns whether cuDNN autotunes (the engine's ``autotune``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    else:
        torch.backends.cudnn.benchmark = bool(cfg.USE_BENCHMARK)
    return torch.backends.cudnn.benchmark


if __name__ == "__main__":
    sys.exit(main())
