"""Floating-point operations of the model's work, as
``torch.utils.flop_counter`` counts them: 2 per multiply-add of the
convolutions, transposed convolutions and matrix products, forward and
backward."""

from __future__ import annotations

from typing import Callable, Dict, Sequence


def count_flops(fn: Callable[[], object]) -> int:
    """FLOPs of one ``fn()``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


def train_flops(config: Dict, batch: int, hw: Sequence[int]) -> int:
    """FLOPs of one forward and backward of the configuration's plain
    reference (``check.reference_module``) on a (batch, h, w, 3) image,
    counted on the meta device: the count is of the work the model
    defines, whatever kernels the program runs it on, and it holds no
    device memory."""
    import torch

    from ..check import reference_module

    with torch.device("meta"):
        model = reference_module(config).build(config["model"]).train()
        image = torch.empty(batch, *hw, 3)

    def fwd_bwd():
        out = model(image)
        sum(v.float().mean() for v in out.values()).backward()

    return count_flops(fwd_bwd)
