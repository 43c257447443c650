"""Floating-point operations of the model's work, as
``torch.utils.flop_counter`` counts them: 2 per multiply-add of the
convolutions, transposed convolutions and matrix products, forward and
backward."""

from __future__ import annotations

from typing import Callable


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one ``fn()``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())
