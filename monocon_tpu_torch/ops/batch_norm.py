"""Train-mode batch norm of a contiguous NCHW float32 tensor on the card:
Triton kernels.

It replaces no TPU kernel. It exists because the float32 model runs in
contiguous NCHW on the card (``models/detector.py``), where cuDNN's and
PyTorch's own train-mode batch-norm kernels give each channel one block of
threads: over a wide map of few channels (16 channels of 384x1248 at
batch 8) they leave most of the card's 132 SMs idle, and take several
times as long as cuDNN's channels_last kernels.

The work is bound by bytes: the forward reads ``x`` twice and writes
``y``; the backward reads ``grad`` and ``x`` twice and writes ``dx``. Each
kernel splits a channel's ``B x H*W`` elements over ``B x chunks``
programs, so that some two thousand programs fill the card whatever the
channel count, and the cross-program reduction takes a second launch:

* forward: ``_stats`` writes each program's sums of ``x - k`` and of its
  square (``k`` the channel's first element, which keeps the sums away
  from cancellation); ``_normalize`` adds a channel's partial sums in
  float64, normalises its chunk, and its first program stores the mean
  and the inverse deviation and updates the running stats;
* backward: ``_grad_sums`` writes each program's sums of ``grad`` and of
  ``grad * (x - mean)``; ``_grad_input`` adds them in float64 and writes
  its chunk of ``dx``, its first program the weight's and the bias's
  gradients.

Partial sums are added in a fixed order, so the result is the same from
run to run. The kernels are built by Triton at first use and have no CPU
mode; ``F.batch_norm`` in training is their plain version, against which
``chip_smoke.py`` and the ``cuda``-marked tests hold them.
"""

from __future__ import annotations

from typing import Optional

import torch

# Elements a program reads per step; programs to aim for over the grid.
BLOCK = 1024
TARGET_PROGRAMS = 2048
NUM_WARPS = 4

# Launches of the kernels since the count was last set to 0.
launch_count = 0

_kernels = None


def _load():
    """The four Triton kernels, built at first use."""
    global _kernels
    if _kernels is not None:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def _stats(x_ptr, part_ptr, C, HW, chunk, chunks,
               BLOCK: tl.constexpr):
        s, b, c = tl.program_id(0), tl.program_id(1), tl.program_id(2)
        row = x_ptr + (b * C + c).to(tl.int64) * HW
        k = tl.load(x_ptr + c.to(tl.int64) * HW)
        acc1 = tl.zeros([BLOCK], tl.float32)
        acc2 = tl.zeros([BLOCK], tl.float32)
        for i in range(0, chunk, BLOCK):
            offs = s * chunk + i + tl.arange(0, BLOCK)
            mask = offs < HW
            d = tl.where(mask, tl.load(row + offs, mask=mask) - k, 0.0)
            acc1 += d
            acc2 += d * d
        p = (c * tl.num_programs(1) + b) * chunks + s
        tl.store(part_ptr + 2 * p, tl.sum(acc1, 0))
        tl.store(part_ptr + 2 * p + 1, tl.sum(acc2, 0))

    @triton.jit
    def _normalize(x_ptr, y_ptr, part_ptr, w_ptr, b_ptr, mean_ptr,
                   invstd_ptr, rmean_ptr, rvar_ptr, C, HW, chunk, chunks,
                   n, eps, momentum, HAS_AFFINE: tl.constexpr,
                   P_BLOCK: tl.constexpr, BLOCK: tl.constexpr):
        s, b, c = tl.program_id(0), tl.program_id(1), tl.program_id(2)
        parts = tl.num_programs(1) * chunks
        q = tl.arange(0, P_BLOCK)
        pmask = q < parts
        base = part_ptr + 2 * c * parts
        s1 = tl.sum(tl.load(base + 2 * q, mask=pmask, other=0.0)
                    .to(tl.float64), 0)
        s2 = tl.sum(tl.load(base + 2 * q + 1, mask=pmask, other=0.0)
                    .to(tl.float64), 0)
        k = tl.load(x_ptr + c.to(tl.int64) * HW)
        shifted = s1 / n
        var = tl.maximum(s2 / n - shifted * shifted, 0.0).to(tl.float32)
        mean = (k.to(tl.float64) + shifted).to(tl.float32)
        invstd = 1.0 / tl.sqrt(var + eps)
        if HAS_AFFINE:
            scale = invstd * tl.load(w_ptr + c)
            shift = tl.load(b_ptr + c)
        else:
            scale = invstd
            shift = 0.0
        if (s == 0) & (b == 0):
            tl.store(mean_ptr + c, mean)
            tl.store(invstd_ptr + c, invstd)
            rm = tl.load(rmean_ptr + c)
            rv = tl.load(rvar_ptr + c)
            unbiased = var * (n / tl.maximum(n - 1.0, 1.0))
            tl.store(rmean_ptr + c, rm + momentum * (mean - rm))
            tl.store(rvar_ptr + c, rv + momentum * (unbiased - rv))
        offset = (b * C + c).to(tl.int64) * HW
        for i in range(0, chunk, BLOCK):
            offs = s * chunk + i + tl.arange(0, BLOCK)
            mask = offs < HW
            v = tl.load(x_ptr + offset + offs, mask=mask)
            tl.store(y_ptr + offset + offs, (v - mean) * scale + shift,
                     mask=mask)

    @triton.jit
    def _grad_sums(g_ptr, x_ptr, mean_ptr, part_ptr, C, HW, chunk, chunks,
                   BLOCK: tl.constexpr):
        s, b, c = tl.program_id(0), tl.program_id(1), tl.program_id(2)
        offset = (b * C + c).to(tl.int64) * HW
        mean = tl.load(mean_ptr + c)
        acc1 = tl.zeros([BLOCK], tl.float32)
        acc2 = tl.zeros([BLOCK], tl.float32)
        for i in range(0, chunk, BLOCK):
            offs = s * chunk + i + tl.arange(0, BLOCK)
            mask = offs < HW
            g = tl.load(g_ptr + offset + offs, mask=mask, other=0.0)
            v = tl.load(x_ptr + offset + offs, mask=mask, other=0.0)
            acc1 += g
            acc2 += g * (v - mean)
        p = (c * tl.num_programs(1) + b) * chunks + s
        tl.store(part_ptr + 2 * p, tl.sum(acc1, 0))
        tl.store(part_ptr + 2 * p + 1, tl.sum(acc2, 0))

    @triton.jit
    def _grad_input(g_ptr, x_ptr, dx_ptr, part_ptr, mean_ptr, invstd_ptr,
                    w_ptr, gw_ptr, gb_ptr, C, HW, chunk, chunks, n,
                    HAS_AFFINE: tl.constexpr, P_BLOCK: tl.constexpr,
                    BLOCK: tl.constexpr):
        s, b, c = tl.program_id(0), tl.program_id(1), tl.program_id(2)
        parts = tl.num_programs(1) * chunks
        q = tl.arange(0, P_BLOCK)
        pmask = q < parts
        base = part_ptr + 2 * c * parts
        sum_dy = tl.sum(tl.load(base + 2 * q, mask=pmask, other=0.0)
                        .to(tl.float64), 0).to(tl.float32)
        sum_dy_xmu = tl.sum(tl.load(base + 2 * q + 1, mask=pmask, other=0.0)
                            .to(tl.float64), 0).to(tl.float32)
        mean = tl.load(mean_ptr + c)
        invstd = tl.load(invstd_ptr + c)
        if HAS_AFFINE:
            scale = invstd * tl.load(w_ptr + c)
            if (s == 0) & (b == 0):
                tl.store(gw_ptr + c, sum_dy_xmu * invstd)
                tl.store(gb_ptr + c, sum_dy)
        else:
            scale = invstd
        mean_dy = sum_dy / n
        k = invstd * invstd * sum_dy_xmu / n
        offset = (b * C + c).to(tl.int64) * HW
        for i in range(0, chunk, BLOCK):
            offs = s * chunk + i + tl.arange(0, BLOCK)
            mask = offs < HW
            g = tl.load(g_ptr + offset + offs, mask=mask)
            v = tl.load(x_ptr + offset + offs, mask=mask)
            tl.store(dx_ptr + offset + offs,
                     (g - mean_dy - (v - mean) * k) * scale, mask=mask)

    _kernels = (_stats, _normalize, _grad_sums, _grad_input, triton)
    return _kernels


def split(batch: int, channels: int, hw: int) -> "tuple[int, int]":
    """(chunks, chunk): each (image, channel) row of ``hw`` elements in
    ``chunks`` pieces of ``chunk`` elements (a multiple of ``BLOCK``), so
    that the grid holds about ``TARGET_PROGRAMS`` programs."""
    rows = batch * channels
    most = -(-hw // BLOCK)
    chunks = min(max(-(-TARGET_PROGRAMS // rows), 1), most)
    chunk = -(-hw // (chunks * BLOCK)) * BLOCK
    return -(-hw // chunk), chunk


def _check(x: torch.Tensor) -> None:
    if (x.dim() != 4 or x.dtype != torch.float32 or not x.is_cuda
            or not x.is_contiguous()):
        raise ValueError("batch_norm_nchw's kernels take a contiguous NCHW "
                         f"float32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


class BatchNormNchwCuda(torch.autograd.Function):
    """The kernels' forward and backward; updates the running stats in
    the forward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum,
                eps):
        global launch_count
        _check(x)
        stats, normalize, _, _, triton = _load()
        batch, channels, h, w = x.shape
        hw = h * w
        chunks, chunk = split(batch, channels, hw)
        parts = batch * chunks
        part = torch.empty(channels * parts * 2, dtype=torch.float32,
                           device=x.device)
        y = torch.empty_like(x)
        mean = torch.empty(channels, dtype=torch.float32, device=x.device)
        invstd = torch.empty_like(mean)
        affine = weight is not None
        grid = (chunks, batch, channels)
        stats[grid](x, part, channels, hw, chunk, chunks, BLOCK=BLOCK,
                    num_warps=NUM_WARPS)
        normalize[grid](
            x, y, part, weight if affine else x, bias if affine else x,
            mean, invstd, running_mean, running_var, channels, hw, chunk,
            chunks, float(batch * hw), float(eps), float(momentum),
            HAS_AFFINE=affine, P_BLOCK=triton.next_power_of_2(parts),
            BLOCK=BLOCK, num_warps=NUM_WARPS)
        launch_count += 2
        ctx.save_for_backward(x, weight, mean, invstd)
        return y

    @staticmethod
    def backward(ctx, grad):
        global launch_count
        x, weight, mean, invstd = ctx.saved_tensors
        _, _, grad_sums, grad_input, triton = _load()
        grad = grad.contiguous()
        batch, channels, h, w = x.shape
        hw = h * w
        chunks, chunk = split(batch, channels, hw)
        parts = batch * chunks
        part = torch.empty(channels * parts * 2, dtype=torch.float32,
                           device=x.device)
        dx = torch.empty_like(x)
        affine = weight is not None
        gw = torch.empty_like(mean) if affine else None
        gb = torch.empty_like(mean) if affine else None
        grid = (chunks, batch, channels)
        grad_sums[grid](grad, x, mean, part, channels, hw, chunk, chunks,
                        BLOCK=BLOCK, num_warps=NUM_WARPS)
        grad_input[grid](
            grad, x, dx, part, mean, invstd, weight if affine else x,
            gw if affine else x, gb if affine else x, channels, hw, chunk,
            chunks, float(batch * hw), HAS_AFFINE=affine,
            P_BLOCK=triton.next_power_of_2(parts), BLOCK=BLOCK,
            num_warps=NUM_WARPS)
        launch_count += 2
        return dx, gw, gb, None, None, None, None


def batch_norm_nchw(x: torch.Tensor, weight: Optional[torch.Tensor],
                    bias: Optional[torch.Tensor],
                    running_mean: torch.Tensor, running_var: torch.Tensor,
                    momentum: float, eps: float) -> torch.Tensor:
    """Train-mode ``F.batch_norm`` of (B, C, H, W) ``x``: normalised by the
    batch's biased variance, the running stats moved by ``momentum``
    towards the batch's mean and unbiased variance, by the kernels: ``x``
    is a contiguous float32 CUDA tensor (else ``ValueError``)."""
    return BatchNormNchwCuda.apply(x, weight, bias, running_mean,
                                   running_var, momentum, eps)
