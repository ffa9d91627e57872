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
  penalty of ``losses/connected_component.py`` joins the loss value, never
  the gradient, in one of JAX's two forms: by default (``cc_emit_probs``
  False) inside the step, which scores the detached sigmoid map on the host
  (a synchronous copy, JAX's host callback) and adds the value to the loss
  as ``metrics["cc"]``; with ``cc_emit_probs`` the map goes out as
  ``metrics["cc_probs"]`` for the caller to score on its delayed fetch, as
  ``train_model`` does.

With a process ``group`` (data parallelism; JAX's ``axis_name``) every term
reduces over the group's global batch: CE and BCE are the mean of the ranks'
means (equal shards: the global mean), Dice and the boundary term sum over
the group before their ratios, and the in-step penalty is the ranks' mean.
``cc_probs`` stays this rank's rows.

With a ``shard`` as well (spatial parallelism, ``ops/halo.py``: the logits
are one band of rows, ``group`` holds every rank of the data x spatial
layout) CE, BCE and Dice reduce over ``group`` as before, since every band
has as many pixels; the boundary term and the penalty read whole images,
so each gathers the spatial group's bands of its detached input and
reduces over the shard's data group alone.  ``cc_probs`` then holds this
rank's images whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.collectives import pmean
from ..ops.halo import gather_rows
from .boundary import boundary_loss
from .connected_component import connected_component_loss
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


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Mean CE over all pixels (torch nn.CrossEntropyLoss default), f32; over
    ``group``, the mean of the ranks' means."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -pmean(logp.gather(-1, targets.long().unsqueeze(-1)).mean(), group)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, group=None) -> torch.Tensor:
    """Mean BCEWithLogits (stable formulation), f32.

    With JAX's derivatives where x == 0 (a dead ReLU under a zero bias gives
    exact zeros): ``max`` splits the tie and ``|x|`` takes +1 there, so such
    a logit gets the gradient ``-z`` as in JAX (``clamp`` and ``abs`` would
    give ``1 - z``).  Over ``group``, the mean of the ranks' means."""
    x, z = logits.float(), targets.float()
    abs_x = torch.where(x >= 0, x, -x)
    return pmean((torch.maximum(x, x.new_zeros(())) - x * z
                  + torch.log1p(torch.exp(-abs_x))).mean(), group)


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


def compute_loss(logits: torch.Tensor, targets: torch.Tensor, cfg: LossConfig,
                 group=None, shard=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Compound loss + per-term metrics.  logits (B, H, W, C), targets int (B, H, W);
    every term over ``group``'s global batch when one is given, and over
    whole images from ``shard``'s bands of rows (see the module docstring)."""
    # the group of the terms that read whole images
    image_group = group if shard is None else shard.data_group
    if cfg.n_classes == 1:
        t = torch.div(targets, 2, rounding_mode="floor").float()  # {0,1,2} -> {0,1}
        pred = logits[..., 0]
        ce = bce_with_logits(pred, t, group)
        dl = dice_loss(torch.sigmoid(pred.float()), t, multiclass=False, group=group)
        bl = boundary_loss(pred, t, edge_width=cfg.boundary_edge_width,
                           edge_weight=cfg.boundary_edge_weight, group=image_group,
                           shard=shard)
        loss = ce + dl + cfg.boundary_weight * bl
        metrics = {"ce": ce, "dice": dl, "boundary": bl}
        if cfg.connected_component:
            probs = torch.sigmoid(pred.detach().float())
            if shard is not None:
                probs = gather_rows(probs, shard)
            if cfg.cc_emit_probs:
                metrics["cc_probs"] = probs  # the caller adds the penalty on the host
            else:
                cc = connected_component_loss(
                    probs.cpu().numpy(), edge_distance=cfg.cc_edge_distance,
                    min_area=cfg.cc_min_area, penalty_weight=cfg.cc_penalty_weight)
                cc = pmean(torch.tensor(cc, dtype=torch.float32, device=loss.device),
                           image_group)
                loss = loss + cc
                metrics["cc"] = cc
        metrics["loss"] = loss
        return loss, metrics

    ce = cross_entropy(logits, targets, group)
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(targets.long(), cfg.n_classes).float()
    dl = dice_loss(probs, onehot, multiclass=True, group=group)
    loss = ce + dl
    metrics = {"ce": ce, "dice": dl, "loss": loss}
    if cfg.multiclass_boundary:
        bl = boundary_loss(logits, targets.float(), edge_width=cfg.boundary_edge_width,
                           edge_weight=7.0,  # the reference's commented-out value
                           group=image_group, shard=shard)
        loss = loss + cfg.boundary_weight * bl
        metrics.update({"boundary": bl, "loss": loss})
    return loss, metrics
