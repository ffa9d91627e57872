"""Boundary loss, the port's copy of the JAX package's ``losses/boundary.py``,
with the reference's numerics and every quirk its docstring lists:

* pred (B, H, W, C) with C > 1 takes channel 1 as the foreground;
* an auto-sigmoid when the values look like logits (min < -10 or max > 10
  over the whole batch), decided on the device by ``torch.where``, so the
  train step never waits for the host;
* the target is binarised as ``target == 255`` (in the reference's binary
  train path targets are {0, 1}, so the target boundary is always empty);
* the region pixels form a flattened row-major strip per image, on which
  "boundary" is ``b[i-1] + b[i] + b[i+1] > 0`` and erosion (a sum of 9) can
  never fire;
* each region scores IoU plus ``0.5 * BCE`` of two 0/1 boundaries, and the
  two regions mix as ``(normal + edge_weight * edge) / (1 + edge_weight)``
  over the frame of ``min(edge_width, h)`` pixels.

Every operand comes from a comparison, so the whole term carries zero
gradient, as in torch and JAX; it is computed on a detached input in f32,
whatever the logits' dtype, and never joins the autograd graph.  The
region index tensors depend only on (H, W, edge width) and are built once
per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["boundary_loss"]


@functools.lru_cache(maxsize=32)
def _region_indices(h: int, w: int, edge_width: int, device: torch.device):
    """Row-major flat indices of the border frame and of its complement, as
    int64 tensors on ``device``."""
    edge = np.zeros((h, w), dtype=bool)
    if edge_width > 0:
        edge[:edge_width, :] = True
        edge[-edge_width:, :] = True
        edge[:, :edge_width] = True
        edge[:, -edge_width:] = True
    return (torch.from_numpy(np.flatnonzero(edge)).to(device),
            torch.from_numpy(np.flatnonzero(~edge)).to(device))


def _extract_boundary_strip(strip: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """The reference's 3x3 boundary conv on the (B, N) strip: b[i-1] + b[i] +
    b[i+1] (zero padded), dilation where it is > 0, erosion where it is 9."""
    binary = (strip > 0.5).float()
    padded = F.pad(binary, (1, 1))
    s = padded[:, :-2] + padded[:, 1:-1] + padded[:, 2:]
    dilated = s > 0
    eroded = s == float(kernel_size ** 2)  # never true on a width-1 strip
    return (dilated != eroded).float()


def _regular_loss(pred2d: torch.Tensor, targ2d: torch.Tensor, idx: torch.Tensor,
                  smooth: float) -> torch.Tensor:
    """IoU + 0.5 * BCE of the two boundaries over one region."""
    if idx.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=pred2d.device)
    pred_boundary = _extract_boundary_strip(pred2d[:, idx]).reshape(-1)
    target_boundary = _extract_boundary_strip(targ2d[:, idx]).reshape(-1)

    intersection = (pred_boundary * target_boundary).sum()
    union = pred_boundary.sum() + target_boundary.sum() - intersection
    iou = (intersection + smooth) / (union + smooth)

    # the reference's BCE compares the two extracted 0/1 boundaries, not the
    # probabilities (boundary_loss.py:92-93)
    p = pred_boundary.clamp(1e-6, 1 - 1e-6)
    logits = torch.log(p / (1 - p))
    bce_sum = (logits.clamp(min=0) - logits * target_boundary
               + torch.log1p(torch.exp(-logits.abs()))).sum()
    bce = bce_sum / float(pred_boundary.shape[0])
    return (1.0 - iou) + 0.5 * bce


def boundary_loss(pred_mask: torch.Tensor, target_mask: torch.Tensor, edge_width: int = 64,
                  edge_weight: float = 5.0, smooth: float = 1e-6) -> torch.Tensor:
    """Weighted border-frame boundary loss, a 0-dim f32 tensor without grad.

    pred_mask: (B, H, W) or channel-last (B, H, W, C) (C > 1: channel 1);
    target_mask: (B, H, W).
    """
    if pred_mask.dim() == 4:
        pred_mask = pred_mask[..., 1] if pred_mask.shape[-1] > 1 else pred_mask[..., 0]
    pred = pred_mask.detach().float()
    looks_like_logits = (pred.amin() < -10) | (pred.amax() > 10)
    pred = torch.where(looks_like_logits, torch.sigmoid(pred), pred)

    b, h, w = pred.shape
    binary_target = (target_mask.detach() == 255).float()
    edge_idx, interior_idx = _region_indices(h, w, min(edge_width, h), pred.device)
    pred2d = pred.reshape(b, h * w)
    targ2d = binary_target.reshape(b, h * w)

    normal_loss = _regular_loss(pred2d, targ2d, interior_idx, smooth)
    edge_loss = _regular_loss(pred2d, targ2d, edge_idx, smooth)
    return (normal_loss + edge_weight * edge_loss) / (1.0 + edge_weight)
