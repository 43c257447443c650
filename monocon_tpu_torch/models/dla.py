"""DLA (Deep Layer Aggregation) backbone: DLA-34, 46, 60 and 102.

Port of ``monocon_tpu/models/dla.py`` with the plain stem: a 7x7 stride-1
conv, then level0 and level1, then four aggregation trees of BasicBlocks
(DLA-34) or Bottlenecks (the others), whose roots add a residual in
DLA-102. The JAX
package's W-block space-to-depth stem is a TPU layout for the same
convolutions with the same parameters, so it has no counterpart here.
Module names are the reference's torch keys (``base_layer.0``,
``level2.tree1.conv1``, ``level3.project.0``, ...).

On a band of rows (``TPU.SPATIAL_SHARDS > 1``) the stem's 7x7 and every
3x3 take their halo rows (``layers.Conv2d``); the trees' 2x2 max pools and
the 1x1 convs need none, since every band starts on an even row of every
level.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, batch_norm, conv_bn_relu_layers

# (block, per-level depths, per-level channels, residual root), as in the
# JAX package (dla.py:399-404) and the reference.
ARCH_SETTINGS = {
    34: ("basic", (1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), False),
    46: ("bottleneck", (1, 1, 1, 2, 2, 1), (16, 32, 64, 64, 128, 256), False),
    60: ("bottleneck", (1, 1, 1, 2, 3, 1), (16, 32, 128, 256, 512, 1024),
         False),
    102: ("bottleneck", (1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
          True),
}


class BasicBlock(nn.Module):
    """Two 3x3 convs with a residual."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                            bias=False)
        self.bn1 = batch_norm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.bn2 = batch_norm(out_ch)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 convs at half the width (expansion 2), with a
    residual."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        bottle = out_ch // 2
        self.conv1 = nn.Conv2d(in_ch, bottle, 1, bias=False)
        self.bn1 = batch_norm(bottle)
        self.conv2 = Conv2d(bottle, bottle, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = batch_norm(bottle)
        self.conv3 = nn.Conv2d(bottle, out_ch, 1, bias=False)
        self.bn3 = batch_norm(out_ch)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + residual)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class Root(nn.Module):
    """1x1 aggregation node over the concatenated children; with
    ``residual`` it adds the first child before the ReLU."""

    def __init__(self, in_ch: int, out_ch: int, residual: bool):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 1, bias=False)
        self.bn = batch_norm(out_ch)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """Recursive aggregation tree."""

    def __init__(self, levels: int, block: str, in_ch: int, out_ch: int,
                 stride: int = 1, level_root: bool = False, root_dim: int = 0,
                 root_residual: bool = False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * out_ch
        if level_root:
            root_dim += in_ch
        if levels == 1:
            self.tree1 = BLOCKS[block](in_ch, out_ch, stride)
            self.tree2 = BLOCKS[block](out_ch, out_ch)
            self.root = Root(root_dim, out_ch, root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, in_ch, out_ch, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, block, out_ch, out_ch,
                              root_dim=root_dim + out_ch,
                              root_residual=root_residual)
        self.project = (
            nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, bias=False),
                          batch_norm(out_ch))
            if in_ch != out_ch else None
        )
        self.levels = levels
        self.level_root = level_root
        self.stride = stride

    def forward(self, x, residual=None, children: Optional[List] = None):
        children = [] if children is None else children
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    """Deep Layer Aggregation backbone; returns the 6 feature levels at
    strides 1, 2, 4, 8, 16, 32."""

    def __init__(self, num_layers: int = 34):
        super().__init__()
        if num_layers not in ARCH_SETTINGS:
            raise ValueError(
                f"no DLA-{num_layers}; the variants are "
                f"{sorted(ARCH_SETTINGS)}")
        block, levels, channels, residual_root = ARCH_SETTINGS[num_layers]
        self.channels = channels
        self.base_layer = nn.Sequential(
            *conv_bn_relu_layers(3, channels[0], kernel_size=7))
        self.level0 = nn.Sequential(*[
            m for i in range(levels[0])
            for m in conv_bn_relu_layers(channels[0], channels[0])])
        self.level1 = nn.Sequential(*[
            m for i in range(levels[1])
            for m in conv_bn_relu_layers(channels[0] if i == 0 else channels[1],
                                         channels[1], stride=2 if i == 0 else 1)])
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(
                levels[i], block, channels[i - 1], channels[i], stride=2,
                level_root=(i != 2), root_residual=residual_root))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.base_layer(x)
        outputs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outputs.append(x)
        return tuple(outputs)
