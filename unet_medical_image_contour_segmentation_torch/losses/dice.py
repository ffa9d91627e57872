"""Dice coefficient and loss, the port's copy of the JAX package's
``losses/dice.py``, with the reference's semantics:

* ``dice_coeff(input, target, reduce_batch_first)``: per-sample Dice over the
  trailing two dims, averaged; with ``reduce_batch_first=True`` (3-D input)
  one global Dice over all dims.  Wherever ``sets_sum == 0`` it is replaced
  by ``inter``, so an empty/empty pair scores 1.
* ``dice_loss = 1 - one global Dice``; for multiclass pass channel-last
  (B, H, W, C): the global reduction makes the channel position irrelevant.
"""

from __future__ import annotations

import torch

__all__ = ["dice_coeff", "multiclass_dice_coeff", "dice_loss"]


def _dice(inter_sum: torch.Tensor, sets_sum: torch.Tensor, epsilon: float) -> torch.Tensor:
    sets_sum = torch.where(sets_sum == 0, inter_sum, sets_sum)
    return (inter_sum + epsilon) / (sets_sum + epsilon)


def dice_coeff(input: torch.Tensor, target: torch.Tensor, reduce_batch_first: bool = False,
               epsilon: float = 1e-6) -> torch.Tensor:
    """Mean Dice over the batch, or one global Dice if ``reduce_batch_first``."""
    if input.shape != target.shape:
        raise ValueError(f"input {tuple(input.shape)} and target {tuple(target.shape)} differ")
    if reduce_batch_first and input.dim() != 3:
        raise ValueError("reduce_batch_first takes a 3-D input")
    sum_dims = (-1, -2) if input.dim() == 2 or not reduce_batch_first else (-1, -2, -3)
    inter = 2 * (input * target).sum(dim=sum_dims)
    sets_sum = input.sum(dim=sum_dims) + target.sum(dim=sum_dims)
    return _dice(inter, sets_sum, epsilon).mean()


def _num_classes(x: torch.Tensor) -> int:
    return x.shape[1] if x.dim() == 4 else 1


def _spatial(x: torch.Tensor):
    return x.shape[2:] if x.dim() == 4 else x.shape[1:]


def multiclass_dice_coeff(input: torch.Tensor, target: torch.Tensor,
                          reduce_batch_first: bool = False,
                          epsilon: float = 1e-6) -> torch.Tensor:
    """Dice over a 4-D pair with dim 1 flattened into the batch, as JAX does."""
    b = input.shape[0]
    return dice_coeff(input.reshape(b * _num_classes(input), *_spatial(input)),
                      target.reshape(b * _num_classes(target), *_spatial(target)),
                      reduce_batch_first, epsilon)


def dice_loss(input: torch.Tensor, target: torch.Tensor, multiclass: bool = False,
              epsilon: float = 1e-6) -> torch.Tensor:
    """1 - one global Dice over every element (``multiclass`` changes nothing
    in the value: the reference's flattening of (B, C) is a global sum too)."""
    inter = 2 * (input * target).sum()
    sets_sum = input.sum() + target.sum()
    return 1.0 - _dice(inter, sets_sum, epsilon)
