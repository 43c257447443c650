"""The plain reference of one MonoCon training step.

Targets (CenterNet Gaussians splatted by a dense max over every
instance, one image at a time), the ten losses of the reference with
their weights (wh 0.1, all others 1), backward, the global-norm clip at
35, and AdamW (b2 0.99, eps 1e-8, decoupled weight decay) under the
one-cycle LR and beta1 schedules, written out element by element in
plain PyTorch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

PI = math.pi
MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)
EPS = 1e-12
F32_EPS = float(torch.finfo(torch.float32).eps)
MIN_OVERLAP = 0.3
CLIP = 35.0
B2, ADAM_EPS, WEIGHT_DECAY = 0.99, 1e-8, 1e-5
PERIOD_UP, LR_UP, LR_END, BETA1, BETA1_DIP = 0.4, 10.0, 1e-4, 0.95, 0.85 / 0.95
LOSS_WEIGHTS = {"loss_wh": 0.1}


def normalize(image: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> (x - mean) / std in float32, 0 outside each
    sample's true (h, w)."""
    mean = torch.tensor(MEAN, dtype=torch.float32, device=image.device)
    inv = 1.0 / torch.tensor(STD, dtype=torch.float32, device=image.device)
    out = (image.float() - mean) * inv
    rows = torch.arange(image.shape[1], device=image.device)
    cols = torch.arange(image.shape[2], device=image.device)
    keep = ((rows[None, :, None] < hw[:, 0, None, None])
            & (cols[None, None, :] < hw[:, 1, None, None]))
    return out * keep[..., None]


def gaussian_radius(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b1, c1 = h + w, w * h * (1 - MIN_OVERLAP) / (1 + MIN_OVERLAP)
    r1 = (b1 - torch.sqrt(torch.clamp_min(b1 * b1 - 4 * c1, 0.0))) / 2.0
    b2, c2 = 2 * (h + w), (1 - MIN_OVERLAP) * w * h
    r2 = (b2 - torch.sqrt(torch.clamp_min(b2 * b2 - 16 * c2, 0.0))) / 8.0
    a3, b3 = 4 * MIN_OVERLAP, -2 * MIN_OVERLAP * (h + w)
    c3 = (MIN_OVERLAP - 1) * w * h
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 * b3 - 4 * a3 * c3, 0.0))) / (2 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


def splat(xy: torch.Tensor, radius: torch.Tensor, channel: torch.Tensor,
          valid: torch.Tensor, channels: int, h: int, w: int) -> torch.Tensor:
    """(B, C, H, W): the max over valid instances of exp(-(dx^2 + dy^2) /
    (2 sigma^2)), sigma = (2r + 1) / 6, inside each instance's square of
    half-width r, values under float32 eps dropped. One image at a time."""
    out = []
    ys = torch.arange(h, dtype=torch.float32, device=xy.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=xy.device)[None, :]
    rows = zip(xy.tolist(), radius.tolist(), channel.tolist(), valid.tolist())
    for xy_i, r_i, c_i, v_i in rows:
        maps = torch.zeros(channels, h, w, device=xy.device)
        for (cx, cy), r, c, v in zip(xy_i, r_i, c_i, v_i):
            if not v:
                continue
            sigma = (2.0 * r + 1.0) / 6.0
            dx, dy = xs - cx, ys - cy
            g = torch.exp((-(dx * dx + dy * dy) / (2.0 * sigma * sigma))
                          .double()).float()
            g = torch.where((dx.abs() <= r) & (dy.abs() <= r)
                            & (g >= F32_EPS), g, 0.0)
            maps[c] = torch.maximum(maps[c], g)
        out.append(maps)
    return torch.stack(out)


def angle_to_class(alpha, bins=12):
    size = 2.0 * PI / bins
    shifted = torch.remainder(torch.remainder(alpha, 2.0 * PI) + size / 2.0,
                              2.0 * PI)
    cls = torch.floor(shifted / size)
    return cls.long(), shifted - (cls * size + size / 2.0)


def targets(label: Dict[str, torch.Tensor], feat_hw: Tuple[int, int],
            pad_hw: Tuple[int, int], classes: int = 3, kpts: int = 9
            ) -> Dict[str, torch.Tensor]:
    fh, fw = feat_hw
    hr, wr = fh / pad_hw[0], fw / pad_hw[1]
    box = label["gt_bboxes"].float()
    mask = label["mask"] > 0
    b, o = mask.shape
    ctx = (box[..., 0] + box[..., 2]) * wr / 2.0
    cty = (box[..., 1] + box[..., 3]) * hr / 2.0
    cxi, cyi = ctx.int(), cty.int()
    bw, bh = (box[..., 2] - box[..., 0]) * wr, (box[..., 3] - box[..., 1]) * hr
    radius = torch.clamp_min(torch.trunc(gaussian_radius(bh, bw)), 0).int()
    heat = splat(torch.stack([cxi, cyi], -1), radius, label["gt_labels"].int(),
                 mask, classes, fh, fw)
    m = mask.float()[..., None]
    b3d = label["gt_bboxes_3d"].float()
    a_cls, a_res = angle_to_class(b3d[..., 6])
    kp = label["gt_kpts_2d"].float().reshape(b, o, kpts, 2)
    kx, ky = kp[..., 0] * wr, kp[..., 1] * hr
    kxi, kyi = torch.trunc(kx).int(), torch.trunc(ky).int()
    visible = (label["gt_kpts_valid_mask"].float() >= 1) & mask[..., None]
    on_map = visible & (kxi >= 0) & (kxi < fw) & (kyi >= 0) & (kyi < fh)
    vis = visible.float()
    kheat = splat(torch.stack([kxi, kyi], -1).reshape(b, o * kpts, 2),
                  radius[..., None].expand(b, o, kpts).reshape(b, -1),
                  torch.arange(kpts, device=mask.device).expand(b, o, kpts)
                  .reshape(b, -1), on_map.reshape(b, -1), kpts, fh, fw)
    on = on_map.float()
    return {
        "center_heatmap": heat.permute(0, 2, 3, 1),
        "kpt_heatmap": kheat.permute(0, 2, 3, 1),
        "wh": torch.stack([bw, bh], -1) * m,
        "offset": torch.stack([ctx - cxi, cty - cyi], -1) * m,
        "dim": b3d[..., 3:6] * m,
        "depth": label["depths"].float()[..., None] * m,
        "alpha_cls": torch.where(mask, a_cls, 0),
        "alpha_offset": (a_res * mask)[..., None],
        "c2k": torch.stack([(kx - cxi[..., None]) * vis,
                            (ky - cyi[..., None]) * vis], -1).reshape(b, o, -1),
        "c2k_mask": vis.repeat_interleave(2, -1),
        "kh_offset": torch.stack([(kx - kxi) * on, (ky - kyi) * on],
                                 -1).reshape(b, o, -1),
        "kh_mask": on.repeat_interleave(2, -1),
        "indices": torch.where(mask, cyi * fw + cxi, 0),
        "indices_kpt": torch.where(on_map, kyi * fw + kxi, 0).reshape(b, -1),
        "mask": m,
    }


def gather(feat: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    b, h, w, c = feat.shape
    i = inds.long().clamp(0, h * w - 1)
    return torch.gather(feat.reshape(b, h * w, c), 1,
                        i[..., None].expand(-1, -1, c))


def _mean(total, count):
    return torch.where(count > 0, total / count.clamp_min(1.0), 0.0)


def _focal(pred, target):
    pos = (target == 1.0).float()
    neg = (target < 1.0).float()
    pos_sum = (torch.log(pred + EPS) * (1 - pred) ** 2 * pos).sum()
    neg_sum = (torch.log(1 - pred + EPS) * pred ** 2 * (1 - target) ** 4
               * neg).sum()
    n = pos.sum()
    return torch.where(n == 0, -neg_sum, -(pos_sum + neg_sum) / n.clamp_min(1.0))


def _masked_mean(loss, mask):
    m = torch.broadcast_to(mask, loss.shape)
    return _mean((loss * m).sum(), m.sum())


def _l1(pred, target, mask):
    return _masked_mean(torch.abs(pred - target), mask)


def losses(pred: Dict[str, torch.Tensor], t: Dict[str, torch.Tensor],
           kpts: int = 9, bins: int = 12) -> Dict[str, torch.Tensor]:
    """The ten weighted losses of one batch."""
    m = t["mask"]
    g = {k: gather(pred[k + "_pred"], t["indices"]) for k in
         ("offset", "wh", "dim", "depth", "center2kpt_offset", "alpha_cls",
          "alpha_offset")}
    out = {"loss_center_heatmap": _focal(pred["center_heatmap_pred"],
                                         t["center_heatmap"]),
           "loss_wh": _l1(g["wh"], t["wh"], m),
           "loss_offset": _l1(g["offset"], t["offset"], m)}
    diff = torch.abs(g["dim"] - t["dim"])
    mm = torch.broadcast_to(m, diff.shape)
    rel = diff / torch.where(mm > 0, g["dim"].detach(), 1.0)
    count = mm.sum()
    l1_mean, rel_mean = _mean((diff * mm).sum().detach(), count), _mean(
        (rel * mm).sum().detach(), count)
    comp = torch.where(rel_mean == 0, 1.0, l1_mean / rel_mean)
    out["loss_dim"] = _mean((rel * mm).sum() * comp, count)
    c2k_m = t["c2k_mask"] * m
    out["loss_center2kpt_offset"] = (
        (torch.abs(g["center2kpt_offset"] * c2k_m - t["c2k"]) * m).sum()
        / (c2k_m.sum() + EPS))
    out["loss_kpt_heatmap"] = _focal(pred["kpt_heatmap_pred"],
                                     t["kpt_heatmap"])
    b, o = m.shape[:2]
    kh = gather(pred["kpt_heatmap_offset_pred"], t["indices_kpt"]).reshape(
        b, o, 2 * kpts)
    out["loss_kpt_heatmap_offset"] = (
        (torch.abs(kh * m - t["kh_offset"]) * m).sum()
        / ((t["kh_mask"] * m).sum() + EPS))
    onehot = F.one_hot(t["alpha_cls"], bins).float()
    logits = g["alpha_cls"]
    bce = (torch.clamp_min(logits, 0) - logits * onehot
           + torch.log1p(torch.exp(-torch.abs(logits))))
    out["loss_alpha_cls"] = _masked_mean(bce, m)
    out["loss_alpha_reg"] = _l1((g["alpha_offset"] * onehot).sum(-1, keepdim=True),
                                t["alpha_offset"], m)
    dp = g["depth"]
    lap = (1.4142 * torch.exp(-dp[..., 1:2]) * torch.abs(dp[..., 0:1] - t["depth"])
           + dp[..., 1:2])
    out["loss_depth"] = _masked_mean(lap, m)
    return {k: v * LOSS_WEIGHTS.get(k, 1.0) for k, v in out.items()}


def _anneal(start, end, factor):
    return end + 0.5 * (start - end) * (math.cos(math.pi * factor) + 1.0)


def schedule(count: int, lr: float, total: int) -> Tuple[float, float]:
    """(LR, beta1) of the optimizer step with count ``count``: one cycle
    up for 40% of the steps and down to 1e-4 of the base LR; beta1 the
    inverse cycle, 0.95 -> 0.85 -> 0.95."""
    up = int(total * PERIOD_UP)
    s = count + 1.0

    def cycle(start, peak, end):
        if s < up:
            return _anneal(start, peak, s / max(up, 1))
        return _anneal(peak, end, (s - up) / max(total - up, 1))

    return (cycle(lr, lr * LR_UP, lr * LR_END),
            cycle(BETA1, BETA1 * BETA1_DIP, BETA1))


class AdamW:
    """AdamW with PyTorch's bias corrections, after a global-norm clip."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float,
                 total_steps: int):
        self.params, self.lr, self.total = params, lr, total_steps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self) -> List[torch.Tensor]:
        """One update from the parameters' ``.grad``; returns the clipped
        gradients."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
        scale = min(1.0, CLIP / float(norm)) if float(norm) > 0 else 1.0
        grads = [g * scale for g in grads]
        lr, b1 = schedule(self.count, self.lr, self.total)
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            p.mul_(1 - lr * WEIGHT_DECAY)
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(B2).add_(g * g, alpha=1 - B2)
            p.sub_(lr / c1 * m / (v.sqrt() / math.sqrt(c2) + ADAM_EPS))
        return grads


def train_step(model, opt: AdamW, batch: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """One step on a batch (uint8 image, img_hw, label dict): the losses
    (and their sum, ``total_loss``) and the clipped gradients."""
    img = normalize(batch["img"], batch["img_hw"])
    pad_hw = tuple(img.shape[1:3])
    with torch.no_grad():
        t = targets(batch["label"], (pad_hw[0] // 4, pad_hw[1] // 4), pad_hw)
    model.train()
    out = losses(model(img), t)
    for p in opt.params:
        p.grad = None
    sum(out.values()).backward()
    grads = opt.step()
    out = {k: v.detach() for k, v in out.items()}
    out["total_loss"] = sum(out.values())
    return out, grads
