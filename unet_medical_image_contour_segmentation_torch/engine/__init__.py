"""Checkpoints, the dense Predictor, the optimizer, the train step and loop, validation.

The JAX package's functional train state has other names here, since the
port updates the model and torch's optimizer in place:

* ``init_rmsprop`` -> ``make_optimizer`` (``torch.optim.RMSprop``, JAX's
  rule term for term);
* ``rmsprop_update`` -> ``make_optimizer`` (its ``step``);
* ``TrainState`` -> ``TrainStep`` (the model, the optimizer and the step
  count);
* ``init_train_state`` -> ``TrainStep``.
"""

from .checkpoint import load_checkpoint, load_weights, save_checkpoint, save_checkpoint_async
from .evaluate import evaluate, make_eval_step
from .optim import RMSpropConfig, clip_by_global_norm, make_optimizer, warm_restarts_lr
from .train import TrainStep, make_train_step, train_model

__all__ = [
    "load_checkpoint",
    "load_weights",
    "save_checkpoint",
    "save_checkpoint_async",
    "evaluate",
    "make_eval_step",
    "RMSpropConfig",
    "clip_by_global_norm",
    "make_optimizer",
    "warm_restarts_lr",
    "TrainStep",
    "make_train_step",
    "train_model",
]
