"""Optimizer, gradient clipping and LR schedule, as the JAX package's
``engine/optim.py``.

The reference trains with ``RMSprop(lr=1e-5, weight_decay=1e-8,
momentum=0.999)`` and ``CosineAnnealingWarmRestarts(T_0=4, T_mult=2,
eta_min=1e-7)``.  The JAX package ports torch's RMSprop rule term for term
(``rmsprop_update``: weight decay into the gradient, ``sqrt(avg) + eps``,
momentum on the preconditioned gradient), so here the update is
``torch.optim.RMSprop`` itself.

* :func:`clip_by_global_norm`: ``max_norm / (total + 1e-6)`` clamped to 1,
  in place, with the total norm left on the device (no host sync).
* :func:`warm_restarts_lr`: torch's closed form for any float ``t``, so the
  reference's quirk of stepping the schedule with the Dice score works.
* :func:`opt_state_to_jax` / :func:`load_opt_state`: the optimizer state in
  the JAX layout ``{"square_avg": params, "momentum_buf": params}``, for the
  ``.npz`` checkpoints both packages read; :func:`opt_state_tensors` is its
  host copy per parameter name, before the conversion.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List

import torch
from torch import nn

from ..models.torch_compat import params_tree_from_tensors, tensors_from_params_tree

__all__ = [
    "RMSpropConfig",
    "make_optimizer",
    "clip_by_global_norm",
    "warm_restarts_lr",
    "opt_state_tensors",
    "opt_state_to_jax",
    "load_opt_state",
]


@dataclasses.dataclass(frozen=True)
class RMSpropConfig:
    learning_rate: float = 1e-5
    alpha: float = 0.99         # torch default smoothing constant
    eps: float = 1e-8
    weight_decay: float = 1e-8
    momentum: float = 0.999


def make_optimizer(params: Iterable[torch.Tensor], cfg: RMSpropConfig) -> torch.optim.RMSprop:
    return torch.optim.RMSprop(params, lr=cfg.learning_rate, alpha=cfg.alpha, eps=cfg.eps,
                               weight_decay=cfg.weight_decay, momentum=cfg.momentum)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place as ``torch.nn.utils.clip_grad_norm_`` does;
    returns the f32 norm before clipping, as a tensor."""
    total = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    coef = (max_norm / (total + 1e-6)).clamp(max=1.0)
    torch._foreach_mul_(grads, coef.to(grads[0].dtype))
    return total


def warm_restarts_lr(t: float, base_lr: float, T_0: int = 4, T_mult: int = 2,
                     eta_min: float = 1e-7) -> float:
    """lr at "epoch" ``t`` under CosineAnnealingWarmRestarts (torch closed form)."""
    t = float(t)
    if T_mult == 1:
        t_cur, t_i = t % T_0, float(T_0)
    elif t >= T_0:
        n = math.floor(math.log(t / T_0 * (T_mult - 1) + 1.0) / math.log(T_mult))
        t_cur = t - T_0 * (T_mult ** n - 1) / (T_mult - 1)
        t_i = T_0 * T_mult ** n
    else:
        t_cur, t_i = t, float(T_0)
    return eta_min + (base_lr - eta_min) * (1.0 + math.cos(math.pi * t_cur / t_i)) / 2.0


_STATE_KEYS = (("square_avg", "square_avg"), ("momentum_buf", "momentum_buffer"))


def opt_state_tensors(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The RMSprop state of ``model``'s parameters as ``{JAX key: {parameter
    name: f32 CPU tensor}}``: copies, never views, so a later
    ``optimizer.step`` leaves them as they are (zeros for a parameter that
    has not been stepped yet)."""
    out = {}
    for jax_key, torch_key in _STATE_KEYS:
        tensors = {}
        for name, p in model.named_parameters():
            t = optimizer.state.get(p, {}).get(torch_key)
            tensors[name] = (torch.zeros(p.shape) if t is None
                             else t.detach().to("cpu", torch.float32, copy=True))
        out[jax_key] = tensors
    return out


def opt_state_to_jax(model: nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """The RMSprop state of ``model``'s parameters in the JAX layout (numpy;
    zeros for a parameter that has not been stepped yet)."""
    return {jax_key: params_tree_from_tensors(model, tensors)
            for jax_key, tensors in opt_state_tensors(model, optimizer).items()}


def load_opt_state(model: nn.Module, optimizer: torch.optim.Optimizer, opt_state: dict,
                   step: int = 0) -> None:
    """Put a JAX-layout RMSprop state into ``optimizer`` for ``model``'s
    parameters (which the optimizer must hold), on the parameters' device."""
    per_key = {jax_key: tensors_from_params_tree(model, opt_state[jax_key])
               for jax_key, _ in _STATE_KEYS}
    for name, p in model.named_parameters():
        state = {"step": torch.tensor(float(step))}
        for jax_key, torch_key in _STATE_KEYS:
            state[torch_key] = per_key[jax_key][name].to(p.device, p.dtype).contiguous()
        optimizer.state[p] = state
