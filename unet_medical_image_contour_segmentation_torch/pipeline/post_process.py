"""Host mask post-processing: hole fill, morphological open, area filter.

The port's copy of the JAX package's ``pipeline/post_process.py``.  It works
on {0,1,2} masks on the host with cv2, imported where it is used so the
package imports on machines without it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["remove_internal_regions", "postprocess_mask"]


def remove_internal_regions(mask, foreground_value: int = 2, background_values=(0, 1)):
    """Fill internal non-foreground regions enclosed by foreground contours."""
    import cv2

    mask = np.asarray(mask)
    processed = mask.copy()
    binary = np.zeros_like(mask, dtype=np.uint8)
    binary[mask == foreground_value] = 255

    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    for contour in contours:
        contour_mask = np.zeros_like(binary)
        cv2.drawContours(contour_mask, [contour], -1, 255, -1)
        internal = np.logical_and(binary == 0, contour_mask == 255)
        internal_pixels = np.unique(mask[internal])
        if any(p in background_values for p in internal_pixels):
            processed[internal] = foreground_value
    return processed


def postprocess_mask(mask, min_area: int = 15000, morph_kernel_size: int = 3):
    """Hole fill -> open -> drop 8-connected foreground components < min_area."""
    import cv2

    mask = remove_internal_regions(np.asarray(mask))
    binary = np.zeros_like(mask, dtype=np.uint8)
    binary[mask == 2] = 255

    kernel = np.ones((morph_kernel_size, morph_kernel_size), np.uint8)
    opened = cv2.morphologyEx(binary, cv2.MORPH_OPEN, kernel)

    num_labels, labels, stats, _ = cv2.connectedComponentsWithStats(opened, connectivity=8)
    processed_binary = np.zeros_like(opened)
    for i in range(1, num_labels):
        if stats[i, cv2.CC_STAT_AREA] >= min_area:
            processed_binary[labels == i] = 255

    processed = mask.copy()
    processed[processed_binary == 0] = 0
    processed[processed_binary == 255] = 2
    return processed
