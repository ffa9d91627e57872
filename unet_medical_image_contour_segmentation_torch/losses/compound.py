"""The compound training loss, the port's copy of the JAX package's
``losses/compound.py``.

Multiclass (the main path): ``CrossEntropy(pred, t) + dice_loss(softmax(pred),
one_hot(t), multiclass=True)``, computed in f32 on channel-last logits
(B, H, W, C) and integer targets (B, H, W).  The binary path (BCE + Dice +
boundary, plus the optional connected-component penalty) and the multiclass
boundary term need ``losses/boundary.py``, which is not ported yet: they
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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
    """Mean BCEWithLogits (stable formulation), f32."""
    x, z = logits.float(), targets.float()
    return (x.clamp(min=0) - x * z + torch.log1p(torch.exp(-x.abs()))).mean()


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
    if cfg.n_classes == 1 or cfg.multiclass_boundary:
        raise NotImplementedError("the binary loss and the boundary term need "
                                  "losses/boundary.py, which is not ported yet")
    ce = cross_entropy(logits, targets)
    probs = torch.softmax(logits.float(), dim=-1)
    onehot = F.one_hot(targets.long(), cfg.n_classes).float()
    dl = dice_loss(probs, onehot, multiclass=True)
    loss = ce + dl
    return loss, {"ce": ce, "dice": dl, "loss": loss}
