"""Checkpoints of the port: saving, resuming, and reading ``.pth`` weights.

The resume contract of ``monocon_tpu/engine/checkpoint.py`` (reference
``engine/base_engine.py:155-219``) without Orbax, which needs JAX:

  * :func:`save_checkpoint` writes ``{weight_dir}/epoch_{E:03d}[_final]/``
    holding ``state.pth``, the reference engine container
    ``{'engine_attrs': {...}, 'state_dict': {'model', 'optimizer',
    'scheduler'}}`` (``scheduler`` holds the solver's state: the optimizer
    step count and, with gradient accumulation, the micro-step index and
    the partial mean gradient, so that a save between two optimizer steps
    resumes exactly), and then ``meta.json`` (counters, loss history, data
    seed), each written to a temporary name and renamed into place.
    ``meta.json`` is the commit marker: it is written last, and a save
    over an existing checkpoint removes the old one first.
  * :func:`latest_checkpoint` returns the lexicographically latest such
    directory that holds both files, so auto-resume never restores a
    checkpoint whose save was cut short.
  * :func:`load_checkpoint` restores the model, the optimizer and the
    solver and returns ``meta``.

A ``state.pth`` is a reference-format ``.pth``: :func:`load_weights` reads
it as it reads the reference's, the JAX package's ``save_torch_checkpoint``
and ``scripts/export_torch_ckpt.py`` files (unwrap the container, then
``load_state_dict(strict=True)``). The JAX package's Orbax checkpoints
(directories of another layout) need JAX to read; export them to ``.pth``
first. :func:`load_imagenet_backbone` reads a DLA ImageNet classification
``.pth`` into the detector's backbone.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..solver.schedule import Solver

STATE_FILE = "state.pth"
META_FILE = "meta.json"


def _ckpt_name(epoch: int, final: bool = False) -> str:
    return f"epoch_{epoch:03d}" + ("_final" if final else "")


def _fsync_dir(path: str) -> None:
    """Flush the entries of directory ``path`` (renames, removals) to disk."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _replace_atomically(path: str, write) -> None:
    """``write(file)`` into ``path + '.tmp'``, flush it to disk, rename it
    to ``path`` and flush the rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def save_checkpoint(
    weight_dir: str,
    model: nn.Module,
    optimizer: torch.optim.Optimizer,
    solver: Solver,
    epoch: int,
    global_iters: int,
    final: bool = False,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    path = os.path.abspath(os.path.join(weight_dir, _ckpt_name(epoch, final)))
    os.makedirs(path, exist_ok=True)
    container = {
        "engine_attrs": {"epochs": epoch, "global_iters": global_iters},
        "state_dict": {"model": model.state_dict(),
                       "optimizer": optimizer.state_dict(),
                       "scheduler": solver.state_dict()},
    }
    # meta.json is the COMMIT MARKER, written strictly after state.pth:
    # a crash between the two leaves a directory that resume skips. A
    # save into an existing directory (the periodic saves of one epoch)
    # first retracts the old marker, so that the new state.pth is never
    # read beside the old counters.
    try:
        os.remove(os.path.join(path, META_FILE))
    except FileNotFoundError:
        pass
    _fsync_dir(path)
    _replace_atomically(os.path.join(path, STATE_FILE),
                        lambda f: torch.save(container, f))
    meta = {"epoch": epoch, "global_iters": global_iters, **(extra or {})}
    _replace_atomically(os.path.join(path, META_FILE),
                        lambda f: f.write(json.dumps(meta).encode()))
    return path


def load_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer,
                    solver: Solver) -> Dict[str, Any]:
    """Restore the model, the optimizer and the solver from the checkpoint
    directory ``path``; return its ``meta.json``."""
    container = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                           weights_only=True)
    state = container["state_dict"]
    model.load_state_dict(state["model"], strict=True)
    optimizer.load_state_dict(state["optimizer"])
    solver.load_state_dict(state["scheduler"])
    with open(os.path.join(path, META_FILE)) as f:
        return json.load(f)


def latest_checkpoint(weight_dir: str) -> Optional[str]:
    """Lexicographically latest ``epoch_*`` checkpoint directory, mirroring
    the reference's auto-resume scan (base_engine.py:63-71); only those
    whose save completed (``state.pth`` and the ``meta.json`` marker)."""
    if not os.path.isdir(weight_dir):
        return None
    candidates = sorted(
        d for d in glob.glob(os.path.join(weight_dir, "epoch_*"))
        if os.path.isfile(os.path.join(d, STATE_FILE))
        and os.path.isfile(os.path.join(d, META_FILE))
    )
    return candidates[-1] if candidates else None


def load_weights(path: str, model: nn.Module) -> None:
    """Load the ``.pth``/``.pt`` at ``path`` into ``model``, every key
    required. The file holds the reference engine container
    ``{'state_dict': {'model': sd}}``, ``{'model': sd}`` or a bare state
    dict; it is read on the CPU, tensors and plain containers only
    (``weights_only=True``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, as the JAX package's Orbax checkpoints "
            "are; the port reads .pth/.pt files: convert it with "
            "scripts/export_torch_ckpt.py, or pass the port's "
            f"{_ckpt_name(1)}/{STATE_FILE}")
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path}: want a .pth or .pt checkpoint")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
        if isinstance(state, dict) and "model" in state:
            state = state["model"]
    elif isinstance(state, dict) and "model" in state:
        state = state["model"]
    model.load_state_dict(state, strict=True)


def load_imagenet_backbone(path: str, model: nn.Module) -> None:
    """Load a DLA ImageNet classification ``.pth`` (keys without the
    ``backbone.`` prefix, an ``fc`` head) into ``model.backbone``, as the
    JAX package's ``load_imagenet_backbone`` does
    (``torch_convert.py:215-229``): the ``fc`` keys are dropped, and so
    are ``num_batches_tracked``, which keep their values in the model.
    Every other backbone key is required."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    filtered = {k: v for k, v in state.items()
                if not k.startswith("fc") and "num_batches_tracked" not in k}
    result = model.backbone.load_state_dict(filtered, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or result.unexpected_keys:
        raise RuntimeError(
            f"{path}: not a DLA ImageNet checkpoint of this backbone: "
            f"missing {missing[:5]}, unexpected "
            f"{result.unexpected_keys[:5]}")
