"""Shared model building blocks (NCHW modules; channels_last, but for
contiguous NCHW in float32 on a CUDA device that autotunes: ``detector.py``).

Port of ``monocon_tpu/models/layers.py``. ``nn.BatchNorm2d`` already has the
semantics that the JAX package rebuilds in ``TorchBatchNorm``: it normalises
train-mode activations with the biased batch variance and accumulates the
Bessel-corrected one into ``running_var``. Momenta are torch's: 0.1 for the
backbone and neck, 0.03 for the attentive norms.

Batch moments across ranks and rows. In the JAX package a train step is one
SPMD program, so BatchNorm's moments are global over the devices of the
mesh, and ``bn_mask`` keeps a padded batch's repeated rows out of them.
Here every BatchNorm of the model is a :class:`BatchNorm2d`, and inside
:func:`batch_stats_scope` its train-mode moments are taken by hand: the
sum, the sum of squares and the count of the rows marked valid, summed in
float64 and added over the ranks of a process group in one
autograd-aware all-reduce per layer. The output is normalised in float32
(float64 for a float64 input) by the global biased variance, and
``running_var`` takes the global ``n / max(n - 1, 1)`` correction. Outside a scope each layer runs as it
always did.

Which train-mode BatchNorm runs where. Inside a scope (a step over more
than one rank, or with a ``valid`` row mask): :func:`scoped_batch_norm`,
plain PyTorch ops, in either memory format. Outside one: for a contiguous
NCHW float32 CUDA input, the kernels of ``ops/batch_norm.py``; otherwise
``nn.BatchNorm2d``'s own (cuDNN's on the card). Evaluation always takes
``nn.BatchNorm2d``'s. ``nn.SyncBatchNorm`` is not used: it runs only on CUDA tensors,
and ``convert_sync_batchnorm`` would replace the two subclasses below by a
plain BatchNorm. Nor is ``torch.distributed.nn.functional.all_reduce``,
deprecated in torch 2.13: :class:`AllReduceSum` is its sum.

The image height split over ranks (``TPU.SPATIAL_SHARDS > 1``,
``parallel/spatial.py``). Inside ``spatial_scope`` each rank holds one band
of rows: :class:`Conv2d` takes the rows its window reaches from the bands
above and below before it convolves; BatchNorm's sums, already added over
the group of a ``batch_stats_scope``, count every band once when that
group is every rank; :class:`AttnWeights` adds its per-sample pooled sums
over the space group, in training and evaluation; and the
:class:`MomentsBatchNorm` after it, which then sees the same (B, K, 1, 1)
on every band, takes its moments over the data group alone, so that no
row counts ``S`` times.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..ops.batch_norm import batch_norm_nchw
from ..parallel.mesh import SpatialLayout
from ..parallel.spatial import HaloExchange

BN_MOMENTUM = 0.1
BN_EPS = 1e-5
ATTN_BN_MOMENTUM = 0.03
ATTN_BN_EPS = 1e-3
# Added to the pooled variance of AttnWeights' RSD pooling.
ATTN_VAR_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class BatchStats:
    """Where train-mode BN moments come from: the rows of this rank whose
    ``valid`` (B,) is 1 (all rows when None), over the ranks of ``group``
    (this process alone when None)."""

    group: Optional[dist.ProcessGroup] = None
    valid: Optional[torch.Tensor] = None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` that takes its train-mode moments from the
    :class:`BatchStats` of an enclosing :func:`batch_stats_scope`.

    Outside a scope, a train-mode float32 CUDA input in contiguous NCHW
    (the autotuned float32 model's, ``detector.py``) goes to the kernels of
    ``ops/batch_norm.py``, not cuDNN's or PyTorch's own: for NCHW both
    give each channel one block of threads and are several times slower
    over a wide map of few channels. In channels_last, cuDNN's kernels are
    the fastest and run as before."""

    batch_stats: Optional[BatchStats] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.batch_stats is not None:
            return scoped_batch_norm(self, x, self.batch_stats)
        if (self.training and x.is_cuda and x.dtype == torch.float32
                and x.is_contiguous() and not x.is_contiguous(
                    memory_format=torch.channels_last)):
            self.num_batches_tracked.add_(1)
            return batch_norm_nchw(x, self.weight, self.bias,
                                   self.running_mean, self.running_var,
                                   self.momentum, self.eps)
        return super().forward(x)


@contextlib.contextmanager
def batch_stats_scope(model: nn.Module,
                      group: Optional[dist.ProcessGroup] = None,
                      valid: Optional[torch.Tensor] = None) -> Iterator[None]:
    """Inside, every :class:`BatchNorm2d` of ``model`` in train mode takes
    its moments over the ``valid`` rows and the ranks of ``group``. With
    neither given, nothing changes."""
    if group is None and valid is None:
        yield
        return
    layers = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    stats = BatchStats(group, valid)
    for m in layers:
        m.batch_stats = stats
    try:
        yield
    finally:
        for m in layers:
            m.batch_stats = None


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of a group, on every rank; its
    gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor,
                group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return AllReduceSum.apply(grad, ctx.group), None


def scoped_batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor,
                      stats: BatchStats) -> torch.Tensor:
    """Train-mode BatchNorm of ``x`` (B, C, H, W) with moments over the
    valid rows of every rank of ``stats.group``; updates ``bn``'s running
    stats with them. Normalises in float32 (or float64) and returns
    ``x``'s dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    c = xf.shape[1]
    dims = (0, 2, 3)
    per_row = xf.shape[2] * xf.shape[3]
    if stats.valid is None:
        masked = xf
        count = xf.new_full((1,), float(xf.shape[0] * per_row))
    else:
        valid = stats.valid.to(xf.dtype)
        masked = xf * valid[:, None, None, None]
        count = (valid.sum() * per_row).reshape(1)
    # Sums in float64: E[x^2] - E[x]^2 in float32 would lose the variance
    # of channels whose mean is large against their spread.
    acc = torch.float64
    sums = torch.cat([masked.sum(dims, dtype=acc),
                      (masked * xf).sum(dims, dtype=acc), count.to(acc)])
    if stats.group is not None:
        sums = AllReduceSum.apply(sums, stats.group)
    n = sums[2 * c]
    mean = sums[:c] / n
    var = (sums[c:2 * c] / n - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = bn.momentum
        bn.running_mean.mul_(1.0 - m).add_(mean.to(xf.dtype), alpha=m)
        bn.running_var.mul_(1.0 - m).add_(
            (var * (n / (n - 1.0).clamp_min(1.0))).to(xf.dtype), alpha=m)
        bn.num_batches_tracked.add_(1)
    mean, var = mean.to(xf.dtype), var.to(xf.dtype)
    scale = torch.rsqrt(var + bn.eps)
    if bn.affine:
        scale = scale * bn.weight
    out = (xf - mean[None, :, None, None]) * scale[None, :, None, None]
    if bn.affine:
        out = out + bn.bias[None, :, None, None]
    return out.to(x.dtype)


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with a padding of ``kernel // 2`` that, on a band of
    rows (``spatial`` set by ``spatial_scope``), first takes the rows its
    window reaches from the neighbouring bands: ``padding`` above and
    ``kernel - padding - stride`` below (3 and 3 for the 7x7 stem, 1 and 1
    for a 3x3, the row above alone for a 3x3 of stride 2, whose bands
    start on even rows), then convolves with no padding in H."""

    spatial: Optional[SpatialLayout] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.spatial is None:
            return super().forward(x)
        (kh, _), (sh, _), (ph, pw) = (self.kernel_size, self.stride,
                                      self.padding)
        if x.shape[2] % sh:
            raise ValueError(f"a band of {x.shape[2]} rows under a stride "
                             f"of {sh}")
        x = HaloExchange.apply(x, ph, max(kh - ph - sh, 0), self.spatial)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, pw),
                        self.dilation, self.groups)


def conv_bn_relu_layers(in_ch: int, out_ch: int, kernel_size: int = 3,
                        stride: int = 1) -> list:
    """[conv, bn, relu]: one conv block as the reference ``Sequential`` keys
    it (``level0.0``/``level0.1``, ``base_layer.0``/``base_layer.1``)."""
    return [
        Conv2d(in_ch, out_ch, kernel_size, stride=stride,
               padding=kernel_size // 2, bias=False),
        batch_norm(out_ch),
        nn.ReLU(inplace=True),
    ]


class ConvBnRelu(nn.Module):
    """3x3 conv -> BN -> ReLU with the neck's key names (``conv``, ``bn1``)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 3, padding=1, bias=False)
        self.bn1 = batch_norm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn1(self.conv(x)))


def hsigmoid_v2(x: torch.Tensor) -> torch.Tensor:
    """relu6(x + 3) / 6."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


class MomentsBatchNorm(BatchNorm2d):
    """BatchNorm2d whose train-mode moments are computed here rather than by
    ``F.batch_norm``.

    AttnWeights normalises a ``(B, K, 1, 1)`` tensor, so the reduction count
    is the batch alone. At B=1 ``F.batch_norm`` refuses to train ("Expected
    more than 1 value per channel"); the JAX package instead gives a zero
    variance and a Bessel factor ``n / max(n - 1, 1)``. Doing the moments by
    hand keeps that, so a batch of one trains as it does in JAX.

    A bfloat16 input is normalised in float32, from float32 moments, and
    the result cast back, as flax's BatchNorm does under ``dtype=bfloat16``.

    On a band of rows (``spatial`` set) every rank of a space group holds
    the same input: in training the moments are taken over the data group
    (the ranks of this band) and the valid rows of an enclosing
    ``batch_stats_scope``.
    """

    spatial: Optional[SpatialLayout] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.spatial is not None:
            valid = (None if self.batch_stats is None
                     else self.batch_stats.valid)
            return scoped_batch_norm(
                self, x, BatchStats(self.spatial.data_group, valid))
        if not self.training or self.batch_stats is not None:
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

    The moments are one-pass and unbiased, as in the JAX package. On a band
    of rows (``spatial`` set) the sums, sums of squares and counts are
    added over the space group, so that they are the whole map's."""

    spatial: Optional[SpatialLayout] = None

    def __init__(self, channels: int, num_affine: int):
        super().__init__()
        self.attention = nn.Sequential(
            nn.Conv2d(channels, num_affine, 1, bias=False),
            MomentsBatchNorm(num_affine, eps=BN_EPS, momentum=BN_MOMENTUM),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.spatial is None:
            n = x.shape[2] * x.shape[3]
            s1 = xf.mean((2, 3), keepdim=True)                   # (B, C, 1, 1)
            s2 = (xf * xf).mean((2, 3), keepdim=True)
            bessel = n / max(n - 1, 1)
        else:
            c = x.shape[1]
            count = xf.new_full((x.shape[0], 1), x.shape[2] * x.shape[3])
            sums = AllReduceSum.apply(torch.cat(
                [xf.sum((2, 3)), (xf * xf).sum((2, 3)), count], 1),
                self.spatial.space_group)
            n = sums[:, 2 * c:][:, :, None, None]
            s1 = sums[:, :c, None, None] / n
            s2 = sums[:, c:2 * c, None, None] / n
            bessel = n / (n - 1).clamp_min(1.0)
        var = ((s2 - s1 * s1) * bessel).clamp_min(0.0)
        y = (s1 * torch.rsqrt(var + ATTN_VAR_EPS)).to(x.dtype)
        y = hsigmoid_v2(self.attention(y))
        return y.reshape(y.shape[0], y.shape[1])


class AttnBatchNorm(BatchNorm2d):
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
