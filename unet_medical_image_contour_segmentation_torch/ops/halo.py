"""Row-sharded images: the halo exchange and the row gather of spatial
parallelism (``parallel/spatial.py``), the port's hand-written form of what
XLA's partitioner inserts around the JAX package's sharded convolutions.

An image's H axis is cut into ``size`` equal bands of rows, band ``index``
on one rank of a spatial group (:class:`Shard`).  A windowed op (a kxk SAME
conv or pool with k = 2p + 1) needs p rows of each neighbour's band: the
halo.  :func:`halo_exchange` hands them over and returns the band with p
rows above and below it (beyond the image's first and last row, rows of a
``fill`` value: zeros, as a conv's SAME padding reads, or -inf for a max
pool's), and its backward sends the halo rows' gradients back to their
owners, who add them to their boundary rows.  The fill rows are made
locally: they are never sent and take no gradient.

Every rank issues the same collectives at the same shapes: the first and
last bands exchange zero rows like any other, so every rank launches the
same kernels and the collectives meet in the same order, in the forward,
in the backward and in a rematerialised block's recompute.

Transport: one SUM all-reduce over the spatial group of a zero-filled
buffer of slots, each slot written by one rank, as
``parallel/data_parallel.py:make_parallel_eval_step`` gathers classes.  A
sum of one value and zeros is that value, so the buffer goes over the wire
as int32 words (bytes where its size is not a multiple of four): the
exchange moves bits, whatever the dtype, and works on every backend (gloo
takes CUDA tensors for ``all_reduce``; NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["Shard", "halo_exchange", "gather_rows", "all_reduce_bits"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's band of rows: ``group`` holds the ``size`` ranks whose
    bands make up the same images, in row order, and this rank holds band
    ``index``.  ``data_group`` holds the ranks with the same band of the
    other images of the global batch (None when there are no others): what
    is computed on whole gathered images reduces over it alone."""

    group: dist.ProcessGroup
    index: int
    size: int
    data_group: Optional[dist.ProcessGroup] = None


def all_reduce_bits(buf: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """SUM all-reduce of ``buf`` in place as int32 words (bytes where its
    size is not a multiple of four); exact for a buffer of slots that one
    rank each writes and the others leave zero."""
    flat = buf.view(-1).view(torch.uint8)
    dist.all_reduce(flat.view(torch.int32) if flat.numel() % 4 == 0 else flat, group=group)
    return buf


class _HaloExchange(torch.autograd.Function):
    """(B, h, W, C) band -> (B, h + 2k, W, C) with k rows of each neighbour."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, shard: Shard, k: int, fill: float) -> torch.Tensor:
        ctx.shard, ctx.k = shard, k
        b, h, w, c = x.shape
        slots = x.new_zeros((shard.size, 2, b, k, w, c))
        slots[shard.index, 0] = x[:, :k]
        slots[shard.index, 1] = x[:, h - k:]
        all_reduce_bits(slots, shard.group)
        r = shard.index
        top = slots[r - 1, 1] if r > 0 else slots.new_full((b, k, w, c), fill)
        bottom = slots[r + 1, 0] if r < shard.size - 1 else slots.new_full((b, k, w, c), fill)
        return torch.cat([top, x, bottom], dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        shard, k = ctx.shard, ctx.k
        b, hk, w, c = g.shape
        h, r = hk - 2 * k, shard.index
        # slot (s, 0) collects the gradient of band s's top rows, which band
        # s - 1 read as its bottom halo; slot (s, 1) that of its bottom rows
        slots = g.new_zeros((shard.size, 2, b, k, w, c))
        if r > 0:
            slots[r - 1, 1] = g[:, :k]
        if r < shard.size - 1:
            slots[r + 1, 0] = g[:, k + h:]
        all_reduce_bits(slots, shard.group)
        dx = g[:, k:k + h].clone()
        dx[:, :k] += slots[r, 0]
        dx[:, h - k:] += slots[r, 1]
        return dx, None, None, None


def halo_exchange(x: torch.Tensor, shard: Shard, k: int, fill: float = 0.0) -> torch.Tensor:
    """NHWC band ``x`` with ``k`` rows of each neighbouring band above and
    below it, rows of ``fill`` beyond the image; differentiable (see the
    module docstring).  Every band must hold at least ``k`` rows."""
    if x.shape[1] < k:
        raise ValueError(f"a band of {x.shape[1]} rows cannot lend a halo of {k} rows: use "
                         f"fewer spatial shards or larger images")
    return _HaloExchange.apply(x, shard, k, fill)


def gather_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The whole images of band ``x`` (B, h, ...) on every rank of the
    spatial group: (B, size * h, ...), detached."""
    b, h = x.shape[:2]
    buf = x.new_zeros((b, shard.size, h, *x.shape[2:]))
    buf[:, shard.index] = x.detach()
    return all_reduce_bits(buf, shard.group).reshape(b, shard.size * h, *x.shape[2:])
