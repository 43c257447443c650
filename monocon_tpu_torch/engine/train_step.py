"""One training step: targets, forward, 10 losses, backward, the solver.

Port of ``monocon_tpu/engine/train_step.py``. Loss weights are the
reference's (wh 0.1, all others 1.0). Targets are constants, so they are
built under ``no_grad`` and stay float32 whatever the model's compute
dtype; on the card their Gaussian heatmaps come from the CUDA splat kernel
(two launches per step, and per micro-step when gradients accumulate).

With the image height split over ranks (a :class:`SpatialLayout`), each
rank holds one band of its data shard's images and the whole-height head
maps come back on every rank of the space group: each generates the whole
targets (its two splat launches) and the same losses from them.

Under a recording ``torch.profiler`` the step is the span ``monocon.step``
with five children, in order: ``.targets``, ``.forward`` (the image's
normalisation and the detector), ``.losses`` (with their all-reduce),
``.backward`` (``zero_grad`` and ``backward()``) and ``.solver``
(``utils/profiling.py::span``; with no profiler recording, each costs a
flag read and a shared no-op context).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.parallel import DistributedDataParallel

from ..losses.losses import (
    LossTerm,
    dim_aware_l1_term,
    gaussian_focal_term,
    laplacian_aleatoric_uncertainty_term,
    masked_binary_cross_entropy_term,
    masked_l1_term,
)
from ..models.layers import batch_stats_scope
from ..ops.heatmap import gather_feature
from ..ops.image_norm import normalize_if_raw
from ..ops.targets import generate_targets
from ..parallel.mesh import SpatialLayout
from ..parallel.spatial import spatial_scope
from ..solver.schedule import Solver
from ..utils.profiling import span

FEAT_STRIDE = 4


def loss_terms(pred: Dict[str, torch.Tensor],
               target: Dict[str, torch.Tensor], num_kpts: int = 9,
               num_alpha_bins: int = 12,
               sample_valid: Optional[torch.Tensor] = None
               ) -> Dict[str, LossTerm]:
    """The ten criteria on fixed-shape (B, O) masked rows, as sums
    (:class:`LossTerm`). ``sample_valid`` (B,) keeps padded batch rows out
    of every term: object rows through the mask, heatmap pixels through the
    focal loss's sample weight."""
    indices = target["indices"]
    indices_kpt = target["indices_kpt"]
    mask = target["mask_target"].to(torch.float32)            # (B, O)
    if sample_valid is not None:
        mask = mask * sample_valid.to(torch.float32)[:, None]
    row_mask = mask[..., None]                                 # (B, O, 1)
    b, o = mask.shape

    gathered = {
        key: gather_feature(pred[key], indices)
        for key in ("offset_pred", "wh_pred", "dim_pred", "depth_pred",
                    "center2kpt_offset_pred", "alpha_cls_pred",
                    "alpha_offset_pred")
    }

    wh = masked_l1_term(gathered["wh_pred"], target["wh_target"], row_mask)
    terms = {
        "loss_center_heatmap": gaussian_focal_term(
            pred["center_heatmap_pred"], target["center_heatmap_target"],
            sample_valid),
        # The reference's weight 0.1, applied to the sums.
        "loss_wh": LossTerm(0.1 * wh.nums, wh.dens, wh.combine),
        "loss_offset": masked_l1_term(gathered["offset_pred"],
                                      target["offset_target"], row_mask),
        "loss_dim": dim_aware_l1_term(gathered["dim_pred"],
                                      target["dim_target"],
                                      gathered["dim_pred"], row_mask),
    }

    # centre->kpt offsets: the prediction zeroed outside the kpt mask,
    # averaged by the kpt-mask count.
    m_c2k = target["mask_center2kpt_offset"] * row_mask
    terms["loss_center2kpt_offset"] = masked_l1_term(
        gathered["center2kpt_offset_pred"] * m_c2k,
        target["center2kpt_offset_target"], row_mask, avg_mask=m_c2k)
    terms["loss_kpt_heatmap"] = gaussian_focal_term(
        pred["kpt_heatmap_pred"], target["kpt_heatmap_target"], sample_valid)

    # kpt-heatmap sub-pixel offsets, gathered at the per-kpt indices: the
    # reference averages |pred - target| over valid-object rows by the
    # kpt-mask count, without zeroing the unmasked components.
    kh_pred = gather_feature(pred["kpt_heatmap_offset_pred"], indices_kpt)
    kh_pred = kh_pred.reshape(b, o, num_kpts * 2)
    terms["loss_kpt_heatmap_offset"] = masked_l1_term(
        kh_pred * row_mask, target["kpt_heatmap_offset_target"], row_mask,
        avg_mask=target["mask_kpt_heatmap_offset"] * row_mask)

    alpha_cls = target["alpha_cls_target"][..., 0].long()
    onehot = F.one_hot(alpha_cls, num_alpha_bins).to(torch.float32)
    terms["loss_alpha_cls"] = masked_binary_cross_entropy_term(
        gathered["alpha_cls_pred"], onehot, row_mask)
    alpha_res_pred = (gathered["alpha_offset_pred"] * onehot).sum(
        -1, keepdim=True)
    terms["loss_alpha_reg"] = masked_l1_term(
        alpha_res_pred, target["alpha_offset_target"], row_mask)
    terms["loss_depth"] = laplacian_aleatoric_uncertainty_term(
        gathered["depth_pred"][..., 0:1], target["depth_target"],
        gathered["depth_pred"][..., 1:2], row_mask)
    return terms


def compute_losses(pred: Dict[str, torch.Tensor],
                   target: Dict[str, torch.Tensor], num_kpts: int = 9,
                   num_alpha_bins: int = 12,
                   sample_valid: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """The ten losses of one batch (:func:`loss_terms`)."""
    return {k: t.value() for k, t in loss_terms(
        pred, target, num_kpts, num_alpha_bins, sample_valid).items()}


def reduce_loss_terms(terms: Dict[str, LossTerm],
                      group: Optional[dist.ProcessGroup] = None,
                      scale: Optional[int] = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(the losses of the global batch, the objective this rank
    differentiates).

    With no group, the losses of this batch and ``scale`` (default 1)
    times their sum. Over a group, every term's sums are added over the
    ranks in one all-reduce, so each rank reads the global losses, as the
    JAX package's SPMD step computes them; the objective is ``scale``
    (default the group's size) times this rank's share of their sum (its
    sums over the global normalisers), so that the gradients that
    DistributedDataParallel averages over its ``scale`` ranks are those of
    the global loss. With the height split, ``group`` is the data group
    (the ranks of a space group hold the same sums) and ``scale`` every
    rank: each band's part of the gradient reaches it through the
    gathered maps' backward."""
    if group is None:
        losses = {k: t.value() for k, t in terms.items()}
        return losses, (scale or 1) * sum(losses.values())
    dtype = next(iter(terms.values())).nums.dtype
    parts = [torch.cat([t.nums.detach().to(dtype), t.dens.to(dtype)])
             for t in terms.values()]
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    world = scale or dist.get_world_size(group)
    losses, objective = {}, 0.0
    for (name, term), total in zip(terms.items(),
                                   flat.split([len(p) for p in parts])):
        nums, dens = total.split([len(term.nums), len(term.dens)])
        losses[name] = term.combine(nums, dens)
        objective = objective + term.combine(term.nums, dens.to(
            term.nums.dtype))
    return losses, world * objective


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               solver: Solver, batch: Dict[str, Any],
               layout: Optional[SpatialLayout] = None
               ) -> Dict[str, torch.Tensor]:
    """One micro-step on ``batch = {'img': (B,H,W,3), 'label': {...},
    'img_hw': optional (B,2), 'valid': optional (B,)}``, all on the model's
    device: the solver steps AdamW on this batch's gradient, or with
    accumulation on every ``grad_accum``-th call (:class:`Solver`). BN
    running stats update on every call. Returns the ten losses and
    ``total_loss``, detached, without a host sync.

    ``valid`` marks a padded batch's real rows: the others count in no
    loss and no BN moment. A ``DistributedDataParallel`` model over more
    than one rank takes its rows of the global batch: BN moments and loss
    normalisers are those of the global batch, the losses returned are the
    global ones, and the averaged gradient is the global loss's.

    ``layout`` splits the height: ``batch['img']`` holds this rank's band
    of the canvas (``layout.band``), the rest is its data shard's whole
    rows, and the model is wrapped over every rank of the layout."""
    with span("monocon.step"):
        group = None
        if isinstance(model, DistributedDataParallel):
            group = model.process_group
            if dist.get_world_size(group) == 1:
                group = None
        loss_group, scale = group, None
        row0, pad_h = 0, batch["img"].shape[1]
        if layout is not None and layout.spatial > 1:
            if group is None:
                raise ValueError("a step on bands of rows needs the model "
                                 "wrapped over every rank (data_parallel)")
            loss_group, scale = layout.data_group, dist.get_world_size(group)
            row0, pad_h = layout.band[0], layout.pad_h
        valid = batch.get("valid")
        pad_hw = (pad_h, batch["img"].shape[2])
        feat_hw = (pad_hw[0] // FEAT_STRIDE, pad_hw[1] // FEAT_STRIDE)
        with span("monocon.step.targets"), torch.no_grad():
            target = generate_targets(batch["label"], feat_hw, pad_hw)

        with span("monocon.step.forward"):
            img = normalize_if_raw(batch["img"], batch.get("img_hw"), row0)
            model.train()
            with spatial_scope(model, layout), batch_stats_scope(
                    model, group, valid):
                pred = model(img)
        with span("monocon.step.losses"):
            losses, objective = reduce_loss_terms(
                loss_terms(pred, target, sample_valid=valid), loss_group,
                scale)
        with span("monocon.step.backward"):
            optimizer.zero_grad(set_to_none=True)
            objective.backward()
        with span("monocon.step.solver"):
            solver.step()
        losses["total_loss"] = sum(losses.values())
        return {k: v.detach() for k, v in losses.items()}
