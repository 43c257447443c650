"""One-cycle LR and beta1 schedules, AdamW, and optax-style clipping.

Port of ``monocon_tpu/solver/schedule.py``. The LR rises x10 over the
first 40% of the steps, then falls to x1e-4; beta1 dips 0.95 -> 0.8075 ->
0.95 on the inverse cycle. As in the JAX package, the values of the
optimizer step with count ``c`` (0 for the first) are the schedules at
``c + 1``. AdamW takes b2 = 0.99, eps 1e-8 and decoupled weight decay 1e-5
on every parameter, as optax's ``adamw`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

B2 = 0.99
WEIGHT_DECAY = 1e-5
PERIOD_UP = 0.4            # share of the steps spent on the way up
LR_UP_RATIO = 10.0         # peak LR over the base LR
LR_END_RATIO = 1e-4        # final LR over the base LR
BETA1 = 0.95
BETA1_DIP = 0.85 / 0.95    # beta1 at the LR peak over BETA1


def _cos_anneal(start: float, end: float, factor: float) -> float:
    return end + 0.5 * (start - end) * (math.cos(math.pi * factor) + 1.0)


def _one_cycle(count: int, start: float, peak: float, end: float,
               total_steps: int) -> float:
    steps_up = int(total_steps * PERIOD_UP)
    s = count + 1.0
    if s < steps_up:
        return _cos_anneal(start, peak, s / max(steps_up, 1))
    return _cos_anneal(peak, end, (s - steps_up) / max(total_steps - steps_up, 1))


def one_cycle_lr(count: int, base_lr: float, total_steps: int) -> float:
    return _one_cycle(count, base_lr, base_lr * LR_UP_RATIO,
                      base_lr * LR_END_RATIO, total_steps)


def one_cycle_beta1(count: int, total_steps: int) -> float:
    return _one_cycle(count, BETA1, BETA1 * BETA1_DIP, BETA1, total_steps)


class OneCycleScheduler:
    """Sets the LR and beta1 of each AdamW step.

    Call :meth:`step` before ``optimizer.step()``: it writes the values of
    the coming step into every param group and advances the count, which
    is its whole state (:meth:`state_dict`)."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr: float,
                 total_steps: int):
        self.optimizer = optimizer
        self.lr = lr
        self.total_steps = total_steps
        self.count = 0

    def step(self) -> None:
        lr = one_cycle_lr(self.count, self.lr, self.total_steps)
        beta1 = one_cycle_beta1(self.count, self.total_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            group["betas"] = (beta1, B2)
        self.count += 1

    def state_dict(self) -> Dict[str, int]:
        return {"count": self.count}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.count = int(state["count"])


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2.25e-4,
    total_steps: int = 1,
) -> Tuple[torch.optim.AdamW, OneCycleScheduler]:
    """AdamW with the one-cycle LR and beta1 schedules."""
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(BETA1, B2), eps=1e-8,
                                  weight_decay=WEIGHT_DECAY)
    return optimizer, OneCycleScheduler(optimizer, lr, total_steps)


@torch.no_grad()
def clip_by_global_norm_(grads: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale gradients in place by ``min(1, max_norm / ||g||)`` over their
    global norm, as ``optax.clip_by_global_norm`` does (torch's
    ``clip_grad_norm_`` divides by ``||g|| + 1e-6`` instead). Returns the
    norm. Stays on the device: no host sync."""
    grads = list(grads)
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / norm, max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm
