"""Image preprocessing of the reference dataset (the JAX package's
``data/dataset.py:BasicDataset.preprocess``).  Only ``preprocess`` is ported
so far: the Predictor needs it.  PIL is imported where it is used, so the
package imports on machines without it."""

from __future__ import annotations

import numpy as np

__all__ = ["BasicDataset"]


class BasicDataset:
    @staticmethod
    def preprocess(mask_values, pil_img, scale: float, is_mask: bool):
        """Resize and value-map (mask) or normalise (image) one PIL image.

        Images come back channel-last (H, W, C) float32, /255 when any pixel
        exceeds 1; masks (H, W) int8 with {255: 2, 128: 1, 0: 0}.
        """
        from PIL import Image

        w, h = pil_img.size
        new_w, new_h = int(scale * w), int(scale * h)
        if new_w <= 0 or new_h <= 0:
            raise ValueError(f"scale {scale} collapses a {w}x{h} image to zero pixels")
        pil_img = pil_img.resize((new_w, new_h),
                                 resample=Image.NEAREST if is_mask else Image.BICUBIC)
        img = np.asarray(pil_img)

        if is_mask:
            mask = np.zeros((new_h, new_w), dtype=np.int8)
            mask[img == 255] = 2  # target contour
            mask[img == 128] = 1  # background
            mask[img == 0] = 0    # shadow/ghost
            return mask

        if img.ndim == 2:
            img = img[..., np.newaxis]
        if (img > 1).any():
            img = img.astype(np.float32) / 255.0
        return np.ascontiguousarray(img, dtype=np.float32)
