"""DLA-Up neck (iterative deep aggregation).

Port of ``monocon_tpu/models/neck.py``. The JAX package's
``DepthwiseUpsample`` (an lhs-dilated depthwise conv) is the transposed
convolution ``nn.ConvTranspose2d(C, C, 2f, stride=f, padding=f//2,
groups=C, bias=False)``; its weight is the flax kernel flipped back
spatially (``utils/weights.py``).

On a band of rows (``TPU.SPATIAL_SHARDS > 1``) an up-convolution of factor
f takes one input row from each neighbouring band, and its output is cut
to f times the band; the neck's 3x3 convolutions take their halos in
``layers.Conv2d``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn

from ..parallel.mesh import SpatialLayout
from ..parallel.spatial import HaloExchange
from .layers import ConvBnRelu

# Strides of the aggregated levels relative to the first, which is level 2
# of the backbone (stride 4).
SCALES = (1, 2, 4, 8)
START_LEVEL = 2


def bilinear_upsample_kernel(factor: int) -> torch.Tensor:
    """(2f, 2f) bilinear interpolation kernel."""
    size = 2 * factor
    f = math.ceil(size / 2)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w1d = 1.0 - torch.abs(torch.arange(size, dtype=torch.float32) / f - c)
    return w1d[:, None] * w1d[None, :]


class DepthwiseUpsample(nn.ConvTranspose2d):
    """``ConvTranspose2d(C, C, 2f, stride f, padding f/2, groups C)``. Its
    output row ``o`` reads input rows ``(o + f/2) // f - 1`` to
    ``(o + f/2) // f``, so the rows ``[a f, b f)`` of a band ``[a, b)``
    need input rows ``a - 1`` to ``b``: on a band of rows it takes one row
    from each neighbour (zeros past the canvas), convolves, and keeps
    output rows ``f`` to ``f + f (b - a)``."""

    spatial: Optional[SpatialLayout] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is None:
            return super().forward(x)
        f, h = self.stride[0], x.shape[2]
        out = super().forward(HaloExchange.apply(x, 1, 1, self.spatial))
        return out[:, :, f:f + f * h]


def depthwise_upsample(channels: int, factor: int) -> DepthwiseUpsample:
    return DepthwiseUpsample(channels, channels, 2 * factor, stride=factor,
                             padding=factor // 2, groups=channels, bias=False)


class IDAUp(nn.Module):
    """Iterative deep aggregation over one scale pyramid."""

    def __init__(self, in_channels: Sequence[int], up_factors: Sequence[int],
                 channels: int):
        super().__init__()
        self.n = len(in_channels)
        for i in range(1, self.n):
            self.add_module(f"proj_{i}", ConvBnRelu(in_channels[i], channels))
            self.add_module(f"up_{i}",
                            depthwise_upsample(channels, int(up_factors[i])))
            self.add_module(f"node_{i}", ConvBnRelu(2 * channels, channels))

    def forward(self, layers: List[torch.Tensor]) -> List[torch.Tensor]:
        outs = list(layers)
        for i in range(1, self.n):
            up = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(outs[i]))
            outs[i] = getattr(self, f"node_{i}")(torch.cat([outs[i - 1], up], 1))
        return outs


class DLAUp(nn.Module):
    """Aggregates the backbone levels from ``START_LEVEL`` on down to one
    stride-4 map."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        channels, scales = list(in_channels), list(SCALES)
        self.n = len(channels)
        for i in range(self.n - 1):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(
                channels[j:], [s // scales[j] for s in scales[j:]],
                channels[j]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            channels[j + 1:] = [channels[j]] * len(channels[j + 1:])

    def forward(self, layers: Sequence[torch.Tensor]) -> torch.Tensor:
        layers = list(layers[START_LEVEL:])
        for i in range(self.n - 1):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
        return layers[-1]
