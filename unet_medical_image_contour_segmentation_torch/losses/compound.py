"""The compound training loss, the port's copy of the JAX package's
``losses/compound.py``.

Computed in f32 on channel-last logits (B, H, W, C) and integer targets
(B, H, W), as the reference's ``train.py:118-147``:

* multiclass (the main path): ``CrossEntropy(pred, t) + dice_loss(softmax(pred),
  one_hot(t), multiclass=True)``, plus ``boundary_weight * boundary_loss(pred,
  t, edge_weight=7)`` with ``multiclass_boundary``;
* binary (``n_classes == 1``, the reference's trained boundary models):
  targets ``// 2`` ({0, 1, 2} -> {0, 1}), then ``BCEWithLogits(pred, t) +
  dice_loss(sigmoid(pred), t) + boundary_weight * boundary_loss(pred, t,
  edge_width, edge_weight)``.  With ``connected_component`` the host
  penalty of ``losses/connected_component.py`` joins the loss value (never
  the gradient): ``cc_emit_probs`` must be set, and hands the detached
  sigmoid out as ``metrics["cc_probs"]`` for the caller to score on its
  delayed fetch, as ``train_model`` does.  The JAX package's other route, a
  host callback inside the step, has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .boundary import boundary_loss
from .dice import dice_loss

__all__ = ["LossConfig", "compute_loss", "cross_entropy", "bce_with_logits", "metric_keys"]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    n_classes: int = 3
    boundary_weight: float = 0.25
    boundary_edge_width: int = 51
    boundary_edge_weight: float = 15.0
    multiclass_boundary: bool = False
    connected_component: bool = False
    cc_edge_distance: int = 50
    cc_min_area: int = 1000
    cc_penalty_weight: float = 0.1
    cc_emit_probs: bool = False


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean CE over all pixels (torch nn.CrossEntropyLoss default), f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long().unsqueeze(-1)).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCEWithLogits (stable formulation), f32.

    With JAX's derivatives where x == 0 (a dead ReLU under a zero bias gives
    exact zeros): ``max`` splits the tie and ``|x|`` takes +1 there, so such
    a logit gets the gradient ``-z`` as in JAX (``clamp`` and ``abs`` would
    give ``1 - z``)."""
    x, z = logits.float(), targets.float()
    abs_x = torch.where(x >= 0, x, -x)
    return (torch.maximum(x, x.new_zeros(())) - x * z
            + torch.log1p(torch.exp(-abs_x))).mean()


def metric_keys(cfg: LossConfig) -> Tuple[str, ...]:
    """The metric-dict keys :func:`compute_loss` emits for ``cfg`` (the JAX
    package's list, binary branch included)."""
    if cfg.n_classes == 1:
        keys = ["ce", "dice", "boundary"]
        if cfg.connected_component:
            keys.append("cc_probs" if cfg.cc_emit_probs else "cc")
        return tuple(keys + ["loss"])
    keys = ["ce", "dice", "loss"]
    if cfg.multiclass_boundary:
        keys.append("boundary")
    return tuple(keys)


def compute_loss(logits: torch.Tensor, targets: torch.Tensor,
                 cfg: LossConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Compound loss + per-term metrics.  logits (B, H, W, C), targets int (B, H, W)."""
    if cfg.n_classes == 1:
        t = torch.div(targets, 2, rounding_mode="floor").float()  # {0,1,2} -> {0,1}
        pred = logits[..., 0]
        ce = bce_with_logits(pred, t)
        dl = dice_loss(torch.sigmoid(pred.float()), t, multiclass=False)
        bl = boundary_loss(pred, t, edge_width=cfg.boundary_edge_width,
                           edge_weight=cfg.boundary_edge_weight)
        loss = ce + dl + cfg.boundary_weight * bl
        metrics = {"ce": ce, "dice": dl, "boundary": bl}
        if cfg.connected_component:
            if not cfg.cc_emit_probs:
                raise NotImplementedError(
                    "connected_component needs cc_emit_probs=True: the penalty is scored "
                    "on the host from metrics['cc_probs'] at train_model's delayed fetch; "
                    "the JAX package's in-step callback is not ported")
            # the caller adds the penalty on the host
            metrics["cc_probs"] = torch.sigmoid(pred.detach().float())
        metrics["loss"] = loss
        return loss, metrics

    ce = cross_entropy(logits, targets)
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(targets.long(), cfg.n_classes).float()
    dl = dice_loss(probs, onehot, multiclass=True)
    loss = ce + dl
    metrics = {"ce": ce, "dice": dl, "loss": loss}
    if cfg.multiclass_boundary:
        bl = boundary_loss(logits, targets.float(), edge_width=cfg.boundary_edge_width,
                           edge_weight=7.0)  # the reference's commented-out value
        loss = loss + cfg.boundary_weight * bl
        metrics.update({"boundary": bl, "loss": loss})
    return loss, metrics
