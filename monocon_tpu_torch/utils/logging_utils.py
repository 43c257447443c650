"""Console and metrics logging.

A copy of ``monocon_tpu/utils/logging_utils.py`` (reference
``utils/engine_utils.py``: tprint:83, progress bar:91, and the TensorBoard
tag scheme ``loss/*``, ``eval/*`` of engine/base_engine.py:227-231), with
:func:`count_params` over a torch module.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Dict

from torch import nn


def count_params(model: nn.Module) -> int:
    """Total parameter count (reference ``count_trainable_params``,
    utils/engine_utils.py:34)."""
    return sum(p.numel() for p in model.parameters())


def tprint(message: str, indent: bool = False) -> None:
    now = str(datetime.now())[:-7]
    line = f"[{now}] {message}"
    if indent:
        line = "\n" + line
    print(line, flush=True)


def progress_bar(current: int, total: int, bins: int = 20,
                 filled: str = "#", empty: str = " ") -> str:
    frac = min(max(current / max(total, 1), 0.0), 1.0)
    n = int(frac * bins)
    return f"[{filled * n}{empty * (bins - n)}][{frac * 100:5.2f}%]"


class MetricsWriter:
    """Scalars to ``metrics.jsonl`` in ``log_dir`` (one JSON object per
    call), and to TensorBoard as well where its package is installed."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def add_scalars(self, values: Dict[str, float], tag: str,
                    step: int) -> None:
        payload = {"step": step, "tag": tag}
        for name, value in values.items():
            payload[name] = float(value)
            if self._tb is not None:
                self._tb.add_scalar(f"{tag}/{name}", float(value), step)
        self._jsonl.write(json.dumps(payload) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
