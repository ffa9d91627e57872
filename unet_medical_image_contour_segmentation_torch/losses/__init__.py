"""The training criterion: cross-entropy + Dice, as the JAX package's ``losses/``."""

from .boundary import boundary_loss
from .compound import LossConfig, bce_with_logits, compute_loss, cross_entropy
from .connected_component import connected_component_loss
from .dice import dice_coeff, dice_loss, multiclass_dice_coeff

__all__ = [
    "boundary_loss",
    "LossConfig",
    "bce_with_logits",
    "compute_loss",
    "cross_entropy",
    "connected_component_loss",
    "dice_coeff",
    "dice_loss",
    "multiclass_dice_coeff",
]
