"""The plain reference of the MonoCon detector: DLA-34 / DLA-102 backbone,
DLA-Up neck and the ten heads, in float32 NCHW PyTorch.

A frozen, plain copy of what the detector computes (MonoCon,
arXiv:2112.04628; DLA, arXiv:1707.06484), written from the reference's
layer equations with no kernel, no autocast, no channels_last and no
process group. Module names follow the reference's torch keys
(``backbone.base_layer.0.weight``, ``neck.ida_0.up_1.weight``,
``head.heatmap_head.1.weight_``, ...), so one state dict loads into this
model and into the program under test.

``Precision`` decides how the convolutions compute: ``"float32"`` (TF32
off, the reference) or ``"tf32"`` (TF32 on, the control of a float32
configuration).

A configuration names this file in its ``"reference"`` key; the check
and the FLOP count take the model from :func:`build` and compute under
:func:`backends` (``perfbench/check.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# (block, per-level depths, per-level channels, residual root).
ARCH = {
    34: ("basic", (1, 1, 1, 2, 2, 1), (16, 32, 64, 128, 256, 512), False),
    102: ("bottleneck", (1, 1, 1, 3, 4, 1), (16, 32, 128, 256, 512, 1024),
          True),
}
BN_EPS, BN_MOMENTUM = 1e-5, 0.1
ATTN_BN_EPS, ATTN_BN_MOMENTUM, ATTN_VAR_EPS = 1e-3, 0.03, 1e-3
HEAT_MIN, HEAT_MAX = 1e-4, 1.0 - 1e-4
EPS = 1e-12
START_LEVEL = 2
SCALES = (1, 2, 4, 8)
HEADS = (("heatmap_head", "center_heatmap"), ("kpt_heatmap_head", "kpt_heatmap"),
         ("wh_head", "wh"), ("offset_head", "offset"),
         ("kpt_heatmap_offset_head", "kpt_heatmap_offset"),
         ("center2kpt_offset_head", "center2kpt_offset"), ("dim_head", "dim"),
         ("depth_head", "depth"))


class Precision:
    """How every convolution of a model computes (see the module
    docstring); one object shared by the model's convolutions."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "tf32"):
            raise ValueError(f"precision {mode}: float32 or tf32")
        self.mode = mode


class Conv(nn.Conv2d):
    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride,
                        self.padding, self.dilation, self.groups)


class UpConv(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, None, self.stride,
                                  self.padding, 0, self.groups)


def bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu(cin: int, cout: int, k: int = 3, stride: int = 1) -> list:
    return [Conv(cin, cout, k, stride, k // 2, bias=False), bn(cout),
            nn.ReLU()]


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = bn(cout)
        self.conv2 = Conv(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = bn(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + residual)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        mid = cout // 2
        self.conv1 = Conv(cin, mid, 1, bias=False)
        self.bn1 = bn(mid)
        self.conv2 = Conv(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = bn(mid)
        self.conv3 = Conv(mid, cout, 1, bias=False)
        self.bn3 = bn(cout)

    def forward(self, x, residual=None):
        residual = x if residual is None else residual
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + residual)


class Root(nn.Module):
    def __init__(self, cin, cout, residual):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False)
        self.bn = bn(cout)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, 1)))
        return F.relu(x + children[0] if self.residual else x)


class Tree(nn.Module):
    def __init__(self, levels, block, cin, cout, stride=1, level_root=False,
                 root_dim=0, root_residual=False):
        super().__init__()
        root_dim = root_dim or 2 * cout
        if level_root:
            root_dim += cin
        Block = BasicBlock if block == "basic" else Bottleneck
        if levels == 1:
            self.tree1 = Block(cin, cout, stride)
            self.tree2 = Block(cout, cout)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, block, cin, cout, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, block, cout, cout,
                              root_dim=root_dim + cout,
                              root_residual=root_residual)
        self.project = (nn.Sequential(Conv(cin, cout, 1, bias=False),
                                      bn(cout)) if cin != cout else None)
        self.levels, self.level_root, self.stride = levels, level_root, stride

    def forward(self, x, residual=None, children=None):
        children = [] if children is None else children
        bottom = F.max_pool2d(x, self.stride, self.stride) if self.stride > 1 else x
        residual = self.project(bottom) if self.project is not None else bottom
        if self.level_root:
            children.append(bottom)
        x1 = self.tree1(x, residual)
        if self.levels == 1:
            return self.root(self.tree2(x1), x1, *children)
        children.append(x1)
        return self.tree2(x1, children=children)


class DLA(nn.Module):
    def __init__(self, depth: int):
        super().__init__()
        block, levels, ch, residual_root = ARCH[depth]
        self.base_layer = nn.Sequential(*conv_bn_relu(3, ch[0], 7))
        self.level0 = nn.Sequential(*conv_bn_relu(ch[0], ch[0]))
        self.level1 = nn.Sequential(*conv_bn_relu(ch[0], ch[1], stride=2))
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(
                levels[i], block, ch[i - 1], ch[i], 2, level_root=i != 2,
                root_residual=residual_root))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.base_layer(x)
        outs = []
        for i in range(6):
            x = getattr(self, f"level{i}")(x)
            outs.append(x)
        return outs


class ConvBnRelu(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 1, bias=False)
        self.bn1 = bn(cout)

    def forward(self, x):
        return F.relu(self.bn1(self.conv(x)))


class IDAUp(nn.Module):
    def __init__(self, cins: Sequence[int], factors: Sequence[int], ch: int):
        super().__init__()
        self.n = len(cins)
        for i in range(1, self.n):
            f = int(factors[i])
            self.add_module(f"proj_{i}", ConvBnRelu(cins[i], ch))
            self.add_module(f"up_{i}", UpConv(ch, ch, 2 * f, stride=f,
                                              padding=f // 2, groups=ch,
                                              bias=False))
            self.add_module(f"node_{i}", ConvBnRelu(2 * ch, ch))

    def forward(self, layers):
        outs = list(layers)
        for i in range(1, self.n):
            up = getattr(self, f"up_{i}")(getattr(self, f"proj_{i}")(outs[i]))
            outs[i] = getattr(self, f"node_{i}")(torch.cat([outs[i - 1], up], 1))
        return outs


class DLAUp(nn.Module):
    def __init__(self, cins: Sequence[int]):
        super().__init__()
        ch, scales = list(cins), list(SCALES)
        self.n = len(ch)
        for i in range(self.n - 1):
            j = -i - 2
            self.add_module(f"ida_{i}", IDAUp(
                ch[j:], [s // scales[j] for s in scales[j:]], ch[j]))
            scales[j + 1:] = [scales[j]] * len(scales[j + 1:])
            ch[j + 1:] = [ch[j]] * len(ch[j + 1:])

    def forward(self, layers):
        layers = list(layers[START_LEVEL:])
        for i in range(self.n - 1):
            j = -i - 2
            layers[j:] = getattr(self, f"ida_{i}")(layers[j:])
        return layers[-1]


class AttnWeights(nn.Module):
    def __init__(self, ch: int, k: int):
        super().__init__()
        self.attention = nn.Sequential(Conv(ch, k, 1, bias=False),
                                       nn.BatchNorm2d(k, eps=BN_EPS,
                                                      momentum=BN_MOMENTUM))

    def forward(self, x):
        n = x.shape[2] * x.shape[3]
        s1 = x.mean((2, 3), keepdim=True)
        s2 = (x * x).mean((2, 3), keepdim=True)
        var = ((s2 - s1 * s1) * (n / max(n - 1, 1))).clamp_min(0.0)
        y = self.attention(s1 * torch.rsqrt(var + ATTN_VAR_EPS))
        y = torch.clamp(y + 3.0, 0.0, 6.0) / 6.0
        return y.reshape(y.shape[0], y.shape[1])


class AttnBatchNorm(nn.BatchNorm2d):
    """Affine-free BN scaled and shifted per sample by attention-mixed
    affines ``weight_`` and ``bias_`` (K, C)."""

    def __init__(self, ch: int, k: int = 10):
        super().__init__(ch, eps=ATTN_BN_EPS, momentum=ATTN_BN_MOMENTUM,
                         affine=False)
        self.weight_ = nn.Parameter(torch.ones(k, ch))
        self.bias_ = nn.Parameter(torch.zeros(k, ch))
        self.attn_weights = AttnWeights(ch, k)

    def forward(self, x):
        normed = super().forward(x)
        y = self.attn_weights(x)
        return ((y @ self.weight_)[:, :, None, None] * normed
                + (y @ self.bias_)[:, :, None, None])


def branch(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cin, 3, 1, 1), AttnBatchNorm(cin),
                         nn.ReLU(), Conv(cin, cout, 1))


class Heads(nn.Module):
    def __init__(self, cin, num_classes=3, num_kpts=9, num_bins=12):
        super().__init__()
        widths = (num_classes, num_kpts, 2, 2, 2, 2 * num_kpts, 3, 2)
        for (name, _), width in zip(HEADS, widths):
            self.add_module(name, branch(cin, width))
        self.dir_feat = nn.Sequential(Conv(cin, cin, 3, 1, 1),
                                      AttnBatchNorm(cin), nn.ReLU())
        self.dir_cls = nn.Sequential(Conv(cin, num_bins, 1))
        self.dir_reg = nn.Sequential(Conv(cin, num_bins, 1))

    def forward(self, feat) -> Dict[str, torch.Tensor]:
        out = {key: getattr(self, name)(feat).permute(0, 2, 3, 1)
               for name, key in HEADS}
        d = self.dir_feat(feat)
        out["alpha_cls"] = self.dir_cls(d).permute(0, 2, 3, 1)
        out["alpha_offset"] = self.dir_reg(d).permute(0, 2, 3, 1)
        for key in ("center_heatmap", "kpt_heatmap"):
            out[key] = torch.clamp(torch.sigmoid(out[key]), HEAT_MIN, HEAT_MAX)
        depth = out["depth"]
        out["depth"] = torch.cat(
            [1.0 / (torch.sigmoid(depth[..., 0:1]) + EPS) - 1.0,
             depth[..., 1:2]], -1)
        return {f"{k}_pred": v for k, v in out.items()}


class Detector(nn.Module):
    """(B, H, W, 3) normalised float32 image -> the heads' NHWC maps."""

    def __init__(self, depth: int = 34, num_classes: int = 3,
                 precision: Optional[Precision] = None):
        super().__init__()
        ch = ARCH[depth][2]
        self.backbone = DLA(depth)
        self.neck = DLAUp(ch[START_LEVEL:])
        self.head = Heads(ch[START_LEVEL], num_classes)
        self.precision = precision or Precision()

    def forward(self, image: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.head(self.neck(self.backbone(
            image.permute(0, 3, 1, 2).contiguous())))


def build(model: Dict, precision: str = "float32") -> Detector:
    """The detector a configuration's ``"model"`` dict describes, its
    convolutions computing in ``precision`` (a mode of ``Precision``)."""
    return Detector(int(model["num_layers"]), int(model["num_classes"]),
                    precision=Precision(precision))


@contextlib.contextmanager
def backends(precision: str):
    """TF32 on for the ``tf32`` precision (forward and backward), off
    otherwise."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    tf32 = Precision(precision).mode == "tf32"
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def bilinear_kernel(f: int) -> torch.Tensor:
    """(2f, 2f) bilinear interpolation kernel of an up-convolution."""
    size = 2 * f
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    w1d = 1.0 - torch.abs(torch.arange(size, dtype=torch.float32) / f - c)
    return w1d[:, None] * w1d[None, :]


def fan_in(shape: Tuple[int, ...]) -> int:
    return int(math.prod(shape[1:]))
