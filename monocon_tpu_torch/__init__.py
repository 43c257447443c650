"""MonoCon monocular 3D detection in PyTorch, with hand-written CUDA kernels
for the NVIDIA H100.

A port of the JAX package ``monocon_tpu``, module for module: the same
model, targets, losses, decode and optimizer, the training loop with
checkpoints and resume, and the evaluation path (:class:`MonoConEngine`,
``python -m monocon_tpu_torch.train``, ``python -m monocon_tpu_torch.test``),
held against the JAX package by the ``tests/test_torch_*.py`` parity tests
on the CPU; data-parallel over several GPUs (``parallel/``); and the
bench of its main path (``python -m monocon_tpu_torch.bench``). It
imports nothing of ``monocon_tpu`` and nothing of JAX.

Entry points take a ``device`` argument and run on ``cuda`` unless the
caller passes ``device="cpu"``; without CUDA and without an explicit device
they raise (:func:`resolve_device`).
"""

from .device import resolve_device
from .engine.engine import MonoConEngine
from .engine.train_step import compute_losses, train_step
from .models.detector import MonoConDetector, create_detector
from .ops.decode import decode_predictions
from .ops.image_norm import normalize_if_raw
from .ops.targets import generate_targets
from .solver.schedule import Solver, build_optimizer
from .utils.weights import state_dict_from_jax

__all__ = [
    "MonoConDetector",
    "MonoConEngine",
    "build_optimizer",
    "compute_losses",
    "create_detector",
    "decode_predictions",
    "generate_targets",
    "normalize_if_raw",
    "Solver",
    "resolve_device",
    "state_dict_from_jax",
    "train_step",
]
