"""One training step: targets, forward, 10 losses, backward, the solver.

Port of ``monocon_tpu/engine/train_step.py``. Loss weights are the
reference's (wh 0.1, all others 1.0). Targets are constants, so they are
built under ``no_grad`` and stay float32 whatever the model's compute
dtype; on the card their Gaussian heatmaps come from the CUDA splat kernel
(two launches per step, and per micro-step when gradients accumulate).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..losses.losses import (
    dim_aware_l1_loss,
    gaussian_focal_loss,
    laplacian_aleatoric_uncertainty_loss,
    masked_binary_cross_entropy,
    masked_l1_loss,
)
from ..ops.heatmap import gather_feature
from ..ops.image_norm import normalize_if_raw
from ..ops.targets import generate_targets
from ..solver.schedule import Solver

EPS = 1e-12
FEAT_STRIDE = 4


def compute_losses(pred: Dict[str, torch.Tensor],
                   target: Dict[str, torch.Tensor], num_kpts: int = 9,
                   num_alpha_bins: int = 12) -> Dict[str, torch.Tensor]:
    """The ten criteria on fixed-shape (B, O) masked rows."""
    indices = target["indices"]
    indices_kpt = target["indices_kpt"]
    mask = target["mask_target"].to(torch.float32)            # (B, O)
    row_mask = mask[..., None]                                 # (B, O, 1)
    b, o = mask.shape

    gathered = {
        key: gather_feature(pred[key], indices)
        for key in ("offset_pred", "wh_pred", "dim_pred", "depth_pred",
                    "center2kpt_offset_pred", "alpha_cls_pred",
                    "alpha_offset_pred")
    }

    loss_offset = masked_l1_loss(gathered["offset_pred"],
                                 target["offset_target"], row_mask)
    loss_wh = 0.1 * masked_l1_loss(gathered["wh_pred"], target["wh_target"],
                                   row_mask)
    loss_dim = dim_aware_l1_loss(gathered["dim_pred"], target["dim_target"],
                                 gathered["dim_pred"], row_mask)
    loss_depth = laplacian_aleatoric_uncertainty_loss(
        gathered["depth_pred"][..., 0:1], target["depth_target"],
        gathered["depth_pred"][..., 1:2], row_mask)

    loss_center_heatmap = gaussian_focal_loss(
        pred["center_heatmap_pred"], target["center_heatmap_target"])
    loss_kpt_heatmap = gaussian_focal_loss(
        pred["kpt_heatmap_pred"], target["kpt_heatmap_target"])

    # centre->kpt offsets: the prediction zeroed outside the kpt mask,
    # averaged by the kpt-mask count.
    m_c2k = target["mask_center2kpt_offset"] * row_mask
    loss_center2kpt = masked_l1_loss(
        gathered["center2kpt_offset_pred"] * m_c2k,
        target["center2kpt_offset_target"], row_mask,
        avg_factor=m_c2k.sum() + EPS)

    # kpt-heatmap sub-pixel offsets, gathered at the per-kpt indices: the
    # reference averages |pred - target| over valid-object rows by the
    # kpt-mask count, without zeroing the unmasked components.
    kh_pred = gather_feature(pred["kpt_heatmap_offset_pred"], indices_kpt)
    kh_pred = kh_pred.reshape(b, o, num_kpts * 2)
    m_kh = target["mask_kpt_heatmap_offset"] * row_mask
    loss_kpt_heatmap_offset = masked_l1_loss(
        kh_pred * row_mask, target["kpt_heatmap_offset_target"], row_mask,
        avg_factor=m_kh.sum() + EPS)

    alpha_cls = target["alpha_cls_target"][..., 0].long()
    onehot = F.one_hot(alpha_cls, num_alpha_bins).to(torch.float32)
    loss_alpha_cls = masked_binary_cross_entropy(
        gathered["alpha_cls_pred"], onehot, row_mask)
    alpha_res_pred = (gathered["alpha_offset_pred"] * onehot).sum(
        -1, keepdim=True)
    loss_alpha_reg = masked_l1_loss(alpha_res_pred,
                                    target["alpha_offset_target"], row_mask)

    return {
        "loss_center_heatmap": loss_center_heatmap,
        "loss_wh": loss_wh,
        "loss_offset": loss_offset,
        "loss_dim": loss_dim,
        "loss_center2kpt_offset": loss_center2kpt,
        "loss_kpt_heatmap": loss_kpt_heatmap,
        "loss_kpt_heatmap_offset": loss_kpt_heatmap_offset,
        "loss_alpha_cls": loss_alpha_cls,
        "loss_alpha_reg": loss_alpha_reg,
        "loss_depth": loss_depth,
    }


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               solver: Solver,
               batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One micro-step on ``batch = {'img': (B,H,W,3), 'label': {...},
    'img_hw': optional (B,2)}``, all on the model's device: the solver
    steps AdamW on this batch's gradient, or with accumulation on every
    ``grad_accum``-th call (:class:`Solver`). BN running stats update on
    every call. Returns the ten losses and ``total_loss``, detached, without
    a host sync."""
    img = normalize_if_raw(batch["img"], batch.get("img_hw"))
    pad_hw = (img.shape[1], img.shape[2])
    feat_hw = (pad_hw[0] // FEAT_STRIDE, pad_hw[1] // FEAT_STRIDE)
    with torch.no_grad():
        target = generate_targets(batch["label"], feat_hw, pad_hw)

    model.train()
    losses = compute_losses(model(img), target)
    total = sum(losses.values())
    optimizer.zero_grad(set_to_none=True)
    total.backward()
    solver.step()
    losses["total_loss"] = total
    return {k: v.detach() for k, v in losses.items()}
