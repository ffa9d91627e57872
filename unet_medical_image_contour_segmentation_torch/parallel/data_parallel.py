"""Data-parallel training and evaluation over a ``torch.distributed`` group,
the port's counterpart of the JAX package's ``parallel/data_parallel.py``.

JAX shards the batch over a 1-D ``Mesh('data')`` and runs the step under
``shard_map``; here each rank is a process with its own replica and its own
rows of every global batch, and the same three rules hold:

* BatchNorm reduces its batch statistics over the group (cross-replica BN,
  ``ops/nn.py:batch_norm``) and every loss term over the global batch
  (``losses/*``), so the loss is the single device's on the whole batch;
* the gradients are averaged over the group before the global-norm clip
  and RMSprop, as JAX ``pmean``s them.  Each rank's backward through the
  loss's differentiable all-reduces is ``world_size`` times its share of
  the global gradient (``ops/collectives.py``), so the average is the
  single-device gradient on the global batch;
* the parameters, BN statistics and optimizer state start equal on every
  rank (:func:`replicate`) and stay equal, since every rank applies the same
  update.

A rank's train-step metrics are the global batch's; ``cc_probs`` holds this
rank's rows, as JAX's ``P('data')`` out-spec leaves it sharded.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..engine.evaluate import eval_forward
from ..engine.optim import RMSpropConfig
from ..engine.train import TrainStep
from ..losses.compound import LossConfig

__all__ = ["make_data_group", "batch_slice", "replicate", "make_parallel_train_step",
           "make_parallel_eval_step"]


def make_data_group(n_devices: Optional[int] = None) -> dist.ProcessGroup:
    """The group of the first ``n_devices`` ranks of the default group (all of
    them when None), the counterpart of JAX's ``make_data_mesh``.  Every rank
    of the default group must call it."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first, or "
                           "train with train_model(num_devices=N), which spawns the ranks")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices {n} must lie in 1..{world}, the ranks of the group")
    return dist.group.WORLD if n == world else dist.new_group(list(range(n)))


def batch_slice(global_batch: int, group: dist.ProcessGroup) -> slice:
    """This rank's rows of a global batch of ``global_batch`` rows (a
    multiple of the group's size), the counterpart of JAX's
    ``batch_sharding``."""
    ranks = dist.get_world_size(group)
    if global_batch % ranks:
        raise ValueError(f"batch {global_batch} must be divisible by the {ranks} ranks")
    per = global_batch // ranks
    rank = dist.get_rank(group)
    return slice(rank * per, (rank + 1) * per)


def replicate(model: nn.Module, optimizer: Optional[torch.optim.Optimizer],
              group: dist.ProcessGroup) -> None:
    """Broadcast the parameters, buffers (BN statistics) and optimizer state
    of the group's first rank to the others, in place.  The optimizer state
    must have the same keys on every rank (empty before the first step)."""
    src = dist.get_global_rank(group, 0)
    tensors = [*model.parameters(), *model.buffers()]
    if optimizer is not None:
        for p in model.parameters():
            state = optimizer.state.get(p, {})
            tensors += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src, group=group)


def make_parallel_train_step(model: nn.Module, loss_cfg: LossConfig, opt_cfg: RMSpropConfig,
                             group: dist.ProcessGroup, clipping: float = 1.0) -> TrainStep:
    """The train step over ``group``: ``step(batch, lr)`` with ``batch`` this
    rank's rows on its device, BN and loss over the group's global batch,
    gradients averaged before the clip (JAX ``make_parallel_train_step``)."""
    return TrainStep(model, loss_cfg, opt_cfg, clipping, group=group)


def make_parallel_eval_step(model: nn.Module, group: dist.ProcessGroup
                            ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(image) -> (B, H, W) int32 classes`` of a global batch of B rows
    (a multiple of the group's size) given whole to every rank: each rank
    runs the eval forward (:func:`engine.evaluate.eval_forward`) on its own
    rows, and one SUM all-reduce of the zero-filled map hands every rank all
    of them (the sum works on every backend, gloo on CUDA tensors
    included)."""

    def step(image: torch.Tensor) -> torch.Tensor:
        rows = batch_slice(image.shape[0], group)
        pred = eval_forward(model, image[rows])
        out = pred.new_zeros((image.shape[0], *pred.shape[1:]))
        out[rows] = pred
        dist.all_reduce(out, group=group)
        return out

    return step
