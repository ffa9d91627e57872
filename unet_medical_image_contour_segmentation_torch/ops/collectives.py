"""Cross-replica reductions over a ``torch.distributed`` process group, the
port's counterparts of ``lax.psum`` / ``pmean`` / ``pmax`` inside the JAX
package's ``shard_map`` over the data axis.

``group=None`` means one device: every function then returns its input
unchanged and calls no collective, as the JAX functions do with
``axis_name=None``.

:func:`psum` carries gradients.  Its backward all-reduces (sums) the
upstream gradient, so each rank's backward is the gradient of the sum of
every rank's loss.  A loss that reduces through these sums has the same
value on every rank, so that sum is ``world_size`` times the global loss;
the data-parallel step (``parallel/data_parallel.py``) therefore averages
its gradients over the ranks and gets the single-device gradient on the
global batch.  :func:`pmax` carries none, as JAX's has no differentiation
rule (a minimum is the maximum of the negated values).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["world_size", "psum", "pmean", "pmax"]


def world_size(group: Optional[dist.ProcessGroup]) -> int:
    """The number of ranks in ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """SUM all-reduce whose backward is the SUM all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def psum(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks of ``group``, differentiable."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``psum(x) / world_size``: JAX's ``pmean``."""
    if group is None:
        return x
    return psum(x, group) / dist.get_world_size(group)


def pmax(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """The elementwise maximum over the ranks, detached."""
    y = x.detach()
    if group is None:
        return y
    y = y.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y
