"""Shared model building blocks (NCHW modules, run in channels_last).

Port of ``monocon_tpu/models/layers.py``. ``nn.BatchNorm2d`` already has the
semantics that the JAX package rebuilds in ``TorchBatchNorm``: it normalises
train-mode activations with the biased batch variance and accumulates the
Bessel-corrected one into ``running_var``. Momenta are torch's: 0.1 for the
backbone and neck, 0.03 for the attentive norms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
ATTN_BN_MOMENTUM = 0.03
ATTN_BN_EPS = 1e-3
# Added to the pooled variance of AttnWeights' RSD pooling.
ATTN_VAR_EPS = 1e-3


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv_bn_relu_layers(in_ch: int, out_ch: int, kernel_size: int = 3,
                        stride: int = 1) -> list:
    """[conv, bn, relu]: one conv block as the reference ``Sequential`` keys
    it (``level0.0``/``level0.1``, ``base_layer.0``/``base_layer.1``)."""
    return [
        nn.Conv2d(in_ch, out_ch, kernel_size, stride=stride,
                  padding=kernel_size // 2, bias=False),
        batch_norm(out_ch),
        nn.ReLU(inplace=True),
    ]


class ConvBnRelu(nn.Module):
    """3x3 conv -> BN -> ReLU with the neck's key names (``conv``, ``bn1``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = batch_norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn1(self.conv(x)))


def hsigmoid_v2(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class MomentsBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode moments are computed here rather than by
    ``F.batch_norm``.

    AttnWeights normalises a ``(B, K, 1, 1)`` tensor, so the reduction count
    is the batch alone. At B=1 ``F.batch_norm`` refuses to train ("Expected
    more than 1 value per channel"); the JAX package instead gives a zero
    variance and a Bessel factor ``n / max(n - 1, 1)``. Doing the moments by
    hand keeps that, so a batch of one trains as it does in JAX.

    A bfloat16 input is normalised in float32, from float32 moments, and
    the result cast back, as flax's BatchNorm does under ``dtype=bfloat16``.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        n = xf.numel() // xf.shape[1]
        mean = xf.mean(dims)
        var = (xf - mean[None, :, None, None]).square().mean(dims)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(
                var.detach() * (n / max(n - 1, 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = ((xf - mean[None, :, None, None]) * scale[None, :, None, None]
               + self.bias[None, :, None, None])
        return out.to(x.dtype)


class AttnWeights(nn.Module):
    """Instance attention over K affines: RSD pooling over H, W, then a 1x1
    conv, a BN and a hard sigmoid. Returns (B, K).

    The moments are one-pass and unbiased, as in the JAX package."""

    def __init__(self, channels: int, num_affine: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.Conv2d(channels, num_affine, 1, bias=False),
            MomentsBatchNorm(num_affine, eps=BN_EPS, momentum=BN_MOMENTUM),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[2] * x.shape[3]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        s1 = xf.mean((2, 3), keepdim=True)                       # (B, C, 1, 1)
        s2 = (xf * xf).mean((2, 3), keepdim=True)
        var = ((s2 - s1 * s1) * (n / max(n - 1, 1))).clamp_min(0.0)
        y = (s1 * torch.rsqrt(var + ATTN_VAR_EPS)).to(x.dtype)
        y = hsigmoid_v2(self.attention(y))
        return y.reshape(y.shape[0], y.shape[1])


class AttnBatchNorm(nn.BatchNorm2d):
    """Attentive normalisation: an affine-free BN (momentum 0.03, eps 1e-3)
    scaled and shifted per sample by the attention-mixed K affines
    ``weight_`` and ``bias_`` (K, C).

    A ``BatchNorm2d`` itself, so that its running stats sit at the module's
    root as in the reference's ``AttnBatchNorm2d``."""

    def __init__(self, channels: int, num_affine: int = 10):
        super().__init__(channels, eps=ATTN_BN_EPS, momentum=ATTN_BN_MOMENTUM,
                         affine=False)
        self.weight_ = nn.Parameter(torch.ones(num_affine, channels))
        self.bias_ = nn.Parameter(torch.zeros(num_affine, channels))
        self.attn_weights = AttnWeights(channels, num_affine)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = super().forward(x)
        y = self.attn_weights(x)                                 # (B, K)
        scale = (y @ self.weight_.to(y.dtype))[:, :, None, None]  # (B, C, 1, 1)
        shift = (y @ self.bias_.to(y.dtype))[:, :, None, None]
        return scale * normed + shift
