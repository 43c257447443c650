"""MonoCon training criteria on fixed-shape masked rows.

Port of ``monocon_tpu/losses/losses.py``: masked means over ``(B, O, C)``
rows instead of the reference's ragged filtering, with a zero loss on an
empty mask.

Each criterion is built as a :class:`LossTerm`, sums over the batch and a
rule that makes the loss of them. The sums of several ranks' terms add up
to the sums of their joint batch, so a data-parallel step reduces them
and gets the loss of the global batch, as the JAX package's SPMD step
does (``engine/train_step.py::reduce_loss_terms``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

EPS = 1e-12
FOCAL_GAMMA = 2.0
FOCAL_BETA = 4.0


class LossTerm(NamedTuple):
    """A loss as ``combine(nums, dens)``. ``nums`` (k,) are sums that carry
    the gradient, ``dens`` (m,) constant sums (counts, detached values);
    ``combine`` is linear in ``nums``, so that ``combine`` of one rank's
    ``nums`` with the global ``dens`` is that rank's share of the global
    loss."""

    nums: torch.Tensor
    dens: torch.Tensor
    combine: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def value(self) -> torch.Tensor:
        return self.combine(self.nums, self.dens)


def _masked_mean_of(total_loss: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
    """The mean from its sum and count; 0 when the count is 0."""
    mean = total_loss / torch.clamp_min(count, 1.0)
    return torch.where(count > 0, mean, torch.zeros_like(mean))


def _sums(*values: torch.Tensor) -> torch.Tensor:
    return torch.stack([v.sum() for v in values])


def _mean_rule(nums: torch.Tensor, dens: torch.Tensor) -> torch.Tensor:
    return _masked_mean_of(nums[0], dens[0])


def masked_mean_term(loss: torch.Tensor, mask: torch.Tensor) -> LossTerm:
    """Mean over the elements where mask == 1; 0 when the mask is empty."""
    mask = torch.broadcast_to(mask, loss.shape).to(loss.dtype)
    return LossTerm(_sums(loss * mask), _sums(mask).detach(), _mean_rule)


def _focal_rule(nums: torch.Tensor, dens: torch.Tensor) -> torch.Tensor:
    pos_sum, neg_sum, num_pos = nums[0], nums[1], dens[0]
    return torch.where(num_pos == 0, -neg_sum,
                       -(pos_sum + neg_sum) / torch.clamp_min(num_pos, 1.0))


def gaussian_focal_term(pred: torch.Tensor, target: torch.Tensor,
                        sample_weight: Optional[torch.Tensor] = None
                        ) -> LossTerm:
    """CenterNet penalty-reduced focal loss on sigmoid-clamped heatmaps.
    ``sample_weight`` (B,) zeroes whole samples (padded batch rows) out of
    both terms and the positive count."""
    pos = (target == 1.0).to(pred.dtype)
    neg = (target < 1.0).to(pred.dtype)
    neg_weights = torch.pow(1.0 - target, FOCAL_BETA)
    pos_loss = torch.log(pred + EPS) * torch.pow(1.0 - pred, FOCAL_GAMMA) * pos
    neg_loss = (torch.log(1.0 - pred + EPS) * torch.pow(pred, FOCAL_GAMMA)
                * neg_weights * neg)
    if sample_weight is not None:
        w = sample_weight.reshape(
            (-1,) + (1,) * (pred.ndim - 1)).to(pred.dtype)
        pos, pos_loss, neg_loss = pos * w, pos_loss * w, neg_loss * w
    return LossTerm(_sums(pos_loss, neg_loss), _sums(pos).detach(),
                    _focal_rule)


def _avg_factor_rule(nums: torch.Tensor, dens: torch.Tensor) -> torch.Tensor:
    return nums[0] / (dens[0] + EPS)


def masked_l1_term(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor,
                   avg_mask: Optional[torch.Tensor] = None) -> LossTerm:
    """L1 averaged over the valid elements, or with ``avg_mask`` summed
    over them and divided by ``avg_mask.sum() + EPS`` (the reference's
    ``avg_factor``)."""
    diff = torch.abs(pred - target)
    if avg_mask is None:
        return masked_mean_term(diff, mask)
    mask = torch.broadcast_to(mask, diff.shape).to(diff.dtype)
    return LossTerm(_sums(diff * mask), _sums(avg_mask).detach(),
                    _avg_factor_rule)


def _dim_aware_rule(nums: torch.Tensor, dens: torch.Tensor) -> torch.Tensor:
    l1_sum, loss_sum, count = dens[0], dens[1], dens[2]
    l1_mean = _masked_mean_of(l1_sum, count)
    loss_mean = _masked_mean_of(loss_sum, count)
    compensation = torch.where(loss_mean == 0, torch.ones_like(loss_mean),
                               l1_mean / loss_mean)
    return _masked_mean_of(nums[0] * compensation, count)


def dim_aware_l1_term(pred: torch.Tensor, target: torch.Tensor,
                      dims: torch.Tensor, mask: torch.Tensor) -> LossTerm:
    """|d - d*| / d (``dims`` detached), rescaled by a detached factor so
    that its mean is the plain L1 mean. The objects' rows are divided
    unguarded, as in the reference; the padding rows (``mask`` 0) are not
    divided at all. The reference gathers the objects' rows alone; here
    a padding row gathers the map at index 0, where a bfloat16 prediction
    can be exactly 0, and 0 / 0 would turn the masked sum into NaN."""
    diff = torch.abs(pred - target)
    mask = torch.broadcast_to(mask, diff.shape).to(diff.dtype)
    loss = diff / torch.where(mask > 0, dims.detach(), torch.ones_like(diff))
    loss_sum = (loss * mask).sum()
    return LossTerm(loss_sum.reshape(1),
                    _sums(diff * mask, loss_sum, mask).detach(),
                    _dim_aware_rule)


def laplacian_aleatoric_uncertainty_term(pred: torch.Tensor,
                                         target: torch.Tensor,
                                         log_variance: torch.Tensor,
                                         mask: torch.Tensor) -> LossTerm:
    """1.4142 * exp(-s) * |x - x*| + s over the valid rows (the reference's
    constant, not sqrt(2))."""
    loss = (1.4142 * torch.exp(-log_variance) * torch.abs(pred - target)
            + log_variance)
    return masked_mean_term(loss, mask)


def masked_binary_cross_entropy_term(logits: torch.Tensor,
                                     onehot: torch.Tensor,
                                     mask: torch.Tensor) -> LossTerm:
    """Sigmoid BCE against one-hot targets, mean over valid elements."""
    loss = (torch.clamp_min(logits, 0) - logits * onehot
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return masked_mean_term(loss, mask)
