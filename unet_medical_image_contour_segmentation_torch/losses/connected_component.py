"""Connected-component penalty, the port's copy of the JAX package's
``losses/connected_component.py`` (host side, no gradient).

A cv2 round trip over a (B, H, W) probability array on the host: each
external contour of ``probs > 0.5`` smaller than ``min_area`` costs
``1 - area / min_area``; a larger one whose bounding-box centre lies within
``edge_distance`` of the border costs ``1 - dist / edge_distance``.  The
mean over the batch, times ``penalty_weight``.  The train loop adds it to
the logged loss value only, on its delayed metrics fetch
(``engine/train.py``), as the JAX package's ``train_model`` does.
"""

from __future__ import annotations

import numpy as np

__all__ = ["connected_component_loss"]


def connected_component_loss(pred_mask, edge_distance: int = 50, min_area: int = 1000,
                             penalty_weight: float = 0.1) -> float:
    """Penalty for small components and components hugging the image border."""
    import cv2

    pred = np.asarray(pred_mask)
    batch_size = pred.shape[0]
    penalty = 0.0
    for i in range(batch_size):
        binary = (pred[i] > 0.5).astype(np.uint8)
        contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        h, w = binary.shape
        for contour in contours:
            area = cv2.contourArea(contour)
            if area < min_area:
                penalty += 1.0 - area / min_area
                continue
            x, y, cw, ch = cv2.boundingRect(contour)
            cx, cy = x + cw // 2, y + ch // 2
            dist = min(cx, w - cx, cy, h - cy)
            if dist < edge_distance:
                penalty += 1.0 - dist / edge_distance
    return penalty / batch_size * penalty_weight
