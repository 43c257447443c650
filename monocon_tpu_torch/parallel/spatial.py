"""The image height split over ranks: halo exchanges, gathered rows, and
the scope that hands a model its :class:`~.mesh.SpatialLayout`.

In the JAX package, ``TPU.SPATIAL_SHARDS > 1`` is one sharding annotation
and GSPMD inserts every halo exchange. Here each rank holds one band of
rows of every activation, and the model's layers call these functions:

  * :class:`HaloExchange` before a convolution: the rows of the bands
    above and below that its window reaches, zeros past the canvas's
    edges; its gradient goes back to the rank that owns the rows;
  * :func:`gather_rows` after the heads: the whole map on every rank of
    the space group. Each of them then computes the same losses from it,
    so the gradient that reaches a band is that rank's own slice of its
    gradient, not the sum over the ranks (which would be ``S`` times too
    large, as ``torch.distributed.nn.functional.all_gather``'s would be).

Over gloo, which sends and receives CPU tensors only (two ranks on one
card: NCCL refuses them), the rows of CUDA tensors travel through pinned
host memory; over NCCL they go from card to card.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import SpatialLayout


def _via_host(x: torch.Tensor, group) -> bool:
    """Whether ``x``'s rows go through host memory: a CUDA tensor over
    gloo, which sends and receives CPU tensors only."""
    return x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as the group's backend takes it: contiguous, and copied to
    pinned host memory where :func:`_via_host`."""
    if _via_host(x, group):
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return host.copy_(x)
    return x.contiguous()


def _exchange(layout: SpatialLayout, to_prev: Optional[torch.Tensor],
              to_next: Optional[torch.Tensor], from_prev_rows: int,
              from_next_rows: int, like: torch.Tensor
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Send ``to_prev`` to the band above and ``to_next`` to the band
    below (where they exist and the tensors are given), and receive
    ``from_prev_rows`` rows from the band above and ``from_next_rows``
    from the band below, each shaped as ``like`` but for its rows (dim 2).
    Returns the received tensors on ``like``'s device, None where nothing
    came."""
    group = layout.space_group
    ops, received = [], []
    for peer, rows, send in ((layout.prev_rank, from_prev_rows, to_prev),
                             (layout.next_rank, from_next_rows, to_next)):
        if peer is None:
            received.append(None)
            continue
        if send is not None and send.shape[2] > 0:
            ops.append(dist.P2POp(dist.isend, _staged(send, group), peer,
                                  group))
        if rows > 0:
            shape = (*like.shape[:2], rows, *like.shape[3:])
            buf = (torch.empty(shape, dtype=like.dtype, pin_memory=True)
                   if _via_host(like, group) else
                   torch.empty(shape, dtype=like.dtype, device=like.device))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group))
            received.append(buf)
        else:
            received.append(None)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(None if r is None else r.to(like.device, non_blocking=True)
                 for r in received)


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
            memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class HaloExchange(torch.autograd.Function):
    """(B, C, h, W) band -> (B, C, top + h + bottom, W): the last ``top``
    rows of the band above, this band, the first ``bottom`` rows of the
    band below; zeros past the canvas's top and bottom. Backward: the
    gradient of the received rows goes back to their band, which adds it
    to its own."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, top: int, bottom: int,
                layout: SpatialLayout) -> torch.Tensor:
        ctx.top, ctx.bottom, ctx.layout = top, bottom, layout
        h = x.shape[2]
        if max(top, bottom) > h:
            raise ValueError(f"a halo of {max(top, bottom)} rows is past a "
                             f"band of {h}")
        from_prev, from_next = _exchange(
            layout, x[:, :, :bottom] if bottom else None,
            x[:, :, h - top:] if top else None, top, bottom, x)
        out = torch.empty((*x.shape[:2], top + h + bottom, x.shape[3]),
                          dtype=x.dtype, device=x.device,
                          memory_format=_memory_format(x))
        out[:, :, top:top + h] = x
        for rows, got in ((out[:, :, :top], from_prev),
                          (out[:, :, top + h:], from_next)):
            if got is None:
                rows.zero_()
            else:
                rows.copy_(got)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        top, bottom, layout = ctx.top, ctx.bottom, ctx.layout
        h = grad.shape[2] - top - bottom
        grad_x = grad[:, :, top:top + h].clone()
        # This band's top halo is the band above's last rows, and its
        # bottom halo the band below's first rows: each gets its gradient.
        from_prev, from_next = _exchange(
            layout, grad[:, :, :top] if top else None,
            grad[:, :, top + h:] if bottom else None, bottom, top, grad)
        if from_prev is not None:
            grad_x[:, :, :bottom] += from_prev
        if from_next is not None:
            grad_x[:, :, h - top:] += from_next
        return grad_x, None, None, None


class GatherRows(torch.autograd.Function):
    """(B, h_s, ...) on space rank ``s``, rows ``sizes[s]`` -> (B, sum of
    sizes, ...), the bands in space order, on every rank of the space
    group. Backward: this rank's rows of the gradient (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, sizes: Sequence[int],
                layout: SpatialLayout) -> torch.Tensor:
        s = layout.space_index
        if x.shape[1] != sizes[s]:
            raise ValueError(f"band {s} has {x.shape[1]} rows, not "
                             f"{sizes[s]}")
        ctx.start = sum(sizes[:s])
        ctx.rows = sizes[s]
        group = layout.space_group
        most = max(sizes)
        padded = x
        if x.shape[1] < most:
            padded = torch.cat([x, x.new_zeros((x.shape[0],
                                                most - x.shape[1],
                                                *x.shape[2:]))], 1)
        local = _staged(padded, group)
        parts = [torch.empty_like(local) for _ in sizes]
        dist.all_gather(parts, local, group=group)
        full = torch.cat([p[:, :n] for p, n in zip(parts, sizes)], 1)
        return full.to(x.device, non_blocking=True)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[:, ctx.start:ctx.start + ctx.rows], None, None


def gather_rows(x: torch.Tensor, layout: SpatialLayout) -> torch.Tensor:
    """:class:`GatherRows` of a (B, h, W, C) map of this rank's band, at
    the stride that the band's height gives: the whole map."""
    start, stop = layout.band
    stride = (stop - start) // x.shape[1]
    sizes = [(b - a) // stride for a, b in layout.bands]
    return GatherRows.apply(x, sizes, layout)


@contextlib.contextmanager
def spatial_scope(model: nn.Module,
                  layout: Optional[SpatialLayout]) -> Iterator[None]:
    """Inside, every module of ``model`` that has a ``spatial`` attribute
    (the halo-aware convolutions, the up-convolutions, the pooled
    attention and its BatchNorm, the heads) works on ``layout``'s bands.
    With no layout, or a layout of one band, nothing changes. Unlike
    :func:`~monocon_tpu_torch.models.layers.batch_stats_scope` it holds in
    evaluation too."""
    if layout is None or layout.spatial == 1:
        yield
        return
    modules: List[nn.Module] = [m for m in model.modules()
                                if hasattr(type(m), "spatial")]
    for m in modules:
        m.spatial = layout
    try:
        yield
    finally:
        for m in modules:
            m.spatial = None
