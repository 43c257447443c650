"""The solver: AdamW inside the JAX package's optax chain.

Port of ``monocon_tpu/solver/schedule.py``. :func:`build_optimizer` returns
torch's AdamW and a :class:`Solver`, which does around each AdamW step what
the JAX package's chain ``MultiSteps(chain(clip_by_global_norm,
inject_hyperparams(adamw)))`` does:

  * gradient accumulation with ``optax.MultiSteps``' semantics: with
    ``grad_accum = k > 1`` each call is one micro-step; it folds the
    gradient into a running mean (Welford, as MultiSteps does) and only
    every k-th call steps, on the mean; the calls in between leave the
    parameters, AdamW's state and the schedule as they are;
  * the optax-style global-norm clip (skipped with ``clip_grad_norm=None``);
  * the one-cycle schedules: the LR rises x10 over the first 40% of the
    optimizer steps, then falls to x1e-4; beta1 dips 0.95 -> 0.8075 ->
    0.95 on the inverse cycle. As in the JAX package, the values of the
    optimizer step with count ``c`` (0 for the first) are the schedules at
    ``c + 1``. With ``use_scheduler=False`` the LR stays at ``lr`` and
    beta1 at 0.95.

AdamW takes b2 = 0.99, eps 1e-8 and decoupled weight decay on every
parameter, as optax's ``adamw`` does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

B2 = 0.99
WEIGHT_DECAY = 1e-5
CLIP_GRAD_NORM = 35.0
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


class Solver:
    """Accumulation, clip and schedule around an AdamW optimizer (see the
    module docstring). Call :meth:`step` after ``backward()``.

    Its state (:meth:`state_dict`) is the optimizer step count and, with
    accumulation, the micro-step index and the partial mean gradient."""

    def __init__(self, optimizer: torch.optim.Optimizer, lr: float,
                 total_steps: int, use_scheduler: bool = True,
                 clip_grad_norm: Optional[float] = CLIP_GRAD_NORM,
                 grad_accum: int = 1):
        self.optimizer = optimizer
        self.lr = lr
        self.total_steps = total_steps
        self.use_scheduler = use_scheduler
        self.clip_grad_norm = clip_grad_norm
        self.grad_accum = grad_accum
        self.params: List[torch.nn.Parameter] = [
            p for group in optimizer.param_groups for p in group["params"]]
        self.count = 0          # optimizer steps taken
        self.mini_step = 0      # micro-steps in the current accumulation
        # The global norm of the last clipped gradient, before the clip (a
        # device scalar, read by diagnostics).
        self.grad_norm: Optional[torch.Tensor] = None
        self.acc_grads = ([torch.zeros_like(p) for p in self.params]
                          if grad_accum > 1 else None)

    def hyperparams(self, count: int) -> Tuple[float, float]:
        """(LR, beta1) of the optimizer step with count ``count``."""
        if not self.use_scheduler:
            return self.lr, BETA1
        return (one_cycle_lr(count, self.lr, self.total_steps),
                one_cycle_beta1(count, self.total_steps))

    @property
    def current_lr(self) -> float:
        """The LR of the last optimizer step, or before the first step the
        first step's: what the JAX engine reads from optax's injected
        hyperparams."""
        return self.hyperparams(max(self.count - 1, 0))[0]

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step on the parameters' ``.grad``; returns whether
        AdamW stepped. A parameter without a gradient counts as a zero one:
        optax decays it all the same."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.acc_grads is not None:
            n = self.mini_step
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.grad_accum
            if self.mini_step:
                return False
            for acc, g in zip(self.acc_grads, grads):
                g.copy_(acc)
                acc.zero_()
        if self.clip_grad_norm is not None and self.clip_grad_norm > 0:
            self.grad_norm = clip_by_global_norm_(grads, self.clip_grad_norm)
        lr, beta1 = self.hyperparams(self.count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            group["betas"] = (beta1, B2)
        self.optimizer.step()
        self.count += 1
        return True

    def state_dict(self) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": self.count}
        if self.acc_grads is not None:
            state["mini_step"] = self.mini_step
            state["acc_grads"] = [a.clone() for a in self.acc_grads]
        return state

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        saved = state.get("acc_grads")
        if (self.acc_grads is None) != (saved is None):
            raise ValueError(
                f"the checkpoint was saved with{'' if saved else 'out'} "
                f"gradient accumulation, this run has grad_accum="
                f"{self.grad_accum}")
        if saved is not None:
            if int(state["mini_step"]) >= self.grad_accum:
                raise ValueError(
                    f"the checkpoint is at micro-step {state['mini_step']}, "
                    f"past this run's grad_accum={self.grad_accum}")
            self.mini_step = int(state["mini_step"])
            for acc, value in zip(self.acc_grads, saved, strict=True):
                acc.copy_(value)


def build_optimizer(
    params: Iterable[torch.nn.Parameter],
    lr: float = 2.25e-4,
    weight_decay: float = WEIGHT_DECAY,
    total_steps: int = 1,
    use_scheduler: bool = True,
    clip_grad_norm: Optional[float] = CLIP_GRAD_NORM,
    grad_accum: int = 1,
) -> Tuple[torch.optim.AdamW, Solver]:
    """AdamW and the :class:`Solver` around it, with the options of the
    JAX package's ``build_optimizer``. ``total_steps`` counts optimizer
    steps: loader steps // ``grad_accum``."""
    optimizer = torch.optim.AdamW(params, lr=lr, betas=(BETA1, B2), eps=1e-8,
                                  weight_decay=weight_decay)
    return optimizer, Solver(optimizer, lr, total_steps, use_scheduler,
                             clip_grad_norm, grad_accum)
