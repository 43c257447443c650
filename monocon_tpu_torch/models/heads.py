"""MonoCon's 10 dense prediction heads and their post-ops.

Port of ``monocon_tpu/models/heads.py``. Each branch is the reference's
``Sequential`` (``heatmap_head.0`` conv, ``.1`` AttnBN, ``.2`` ReLU, ``.3``
1x1 conv; ``dir_feat``/``dir_cls``/``dir_reg`` for the direction head), so
that reference keys load as they are. Outputs are NHWC, float32: under
bfloat16 compute the convolutions' outputs are cast to float32 before the
post-ops (sigmoid clamp, depth transform), as in the JAX package.

On a band of rows (``TPU.SPATIAL_SHARDS > 1``) the 3x3 convolutions take
their halos and the attentive norms pool over the whole map
(``layers.py``); the outputs of the last convolutions, about 70 channels
at a quarter of the canvas, are gathered along H in one collective before
the post-ops, so that every rank of the space group returns the whole
maps.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..parallel.mesh import SpatialLayout
from ..parallel.spatial import gather_rows
from .layers import AttnBatchNorm, Conv2d

EPS = 1e-12
HEAT_MIN, HEAT_MAX = 1e-4, 1.0 - 1e-4
# Heatmap prior bias: -log((1 - p) / p), p = 0.1.
PRIOR_BIAS = float(-math.log((1 - 0.1) / 0.1))

# torch module name -> output-key stem of the 8 plain branches.
_BRANCHES = {
    "heatmap_head": "center_heatmap",
    "kpt_heatmap_head": "kpt_heatmap",
    "wh_head": "wh",
    "offset_head": "offset",
    "kpt_heatmap_offset_head": "kpt_heatmap_offset",
    "center2kpt_offset_head": "center2kpt_offset",
    "dim_head": "dim",
    "depth_head": "depth",
}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """A head's NCHW output as contiguous NHWC float32: a permute with no
    copy from channels_last, one copy from contiguous NCHW."""
    return x.permute(0, 2, 3, 1).float().contiguous()


def head_branch(in_ch: int, feat_ch: int, out_ch: int) -> nn.Sequential:
    """3x3 conv -> AttnBN(10) -> ReLU -> 1x1 conv."""
    return nn.Sequential(
        Conv2d(in_ch, feat_ch, 3, padding=1),
        AttnBatchNorm(feat_ch),
        nn.ReLU(inplace=True),
        nn.Conv2d(feat_ch, out_ch, 1),
    )


class MonoConHeads(nn.Module):
    """The 10 heads over the stride-4 feature map. Output dict, NHWC f32:
    center_heatmap (C_cls) and kpt_heatmap (9) sigmoid-clamped; wh, offset,
    kpt_heatmap_offset, center2kpt_offset (18), dim (3); depth
    (``[1/sigmoid(x) - 1, log_var]``); alpha_cls, alpha_offset (12)."""

    spatial: Optional[SpatialLayout] = None

    def __init__(self, in_ch: int, num_classes: int = 3,
                 num_kpts: int = 9, num_alpha_bins: int = 12):
        super().__init__()
        # Each branch's hidden width is the reference's: 64 for DLA-34/46,
        # 128 for DLA-60/102, the width of the map the heads read.
        feat_ch = in_ch
        widths = (num_classes, num_kpts, 2, 2, 2, 2 * num_kpts, 3, 2)
        for name, width in zip(_BRANCHES, widths):
            self.add_module(name, head_branch(in_ch, feat_ch, width))
        self.dir_feat = nn.Sequential(
            Conv2d(in_ch, feat_ch, 3, padding=1),
            AttnBatchNorm(feat_ch),
            nn.ReLU(inplace=True),
        )
        self.dir_cls = nn.Sequential(nn.Conv2d(feat_ch, num_alpha_bins, 1))
        self.dir_reg = nn.Sequential(nn.Conv2d(feat_ch, num_alpha_bins, 1))

    def forward(self, feat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {key: _nhwc(getattr(self, name)(feat))
               for name, key in _BRANCHES.items()}
        dir_feat = self.dir_feat(feat)
        out["alpha_cls"] = _nhwc(self.dir_cls(dir_feat))
        out["alpha_offset"] = _nhwc(self.dir_reg(dir_feat))
        if self.spatial is not None:
            widths = [v.shape[-1] for v in out.values()]
            whole = gather_rows(torch.cat(list(out.values()), -1),
                                self.spatial)
            out = dict(zip(out, whole.split(widths, -1)))

        for key in ("center_heatmap", "kpt_heatmap"):
            out[key] = torch.clamp(torch.sigmoid(out[key]), HEAT_MIN, HEAT_MAX)
        depth = out["depth"]
        depth_val = 1.0 / (torch.sigmoid(depth[..., 0:1]) + EPS) - 1.0
        out["depth"] = torch.cat([depth_val, depth[..., 1:2]], dim=-1)
        return {f"{key}_pred": val for key, val in out.items()}
