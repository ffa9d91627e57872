"""Space-to-depth pack/unpack, as the JAX package's ``ops/s2d.py:s2d``/``d2s``.

The JAX package runs whole levels in this layout to fill the TPU's 128-lane
tiles; the port computes in NHWC and keeps only the two reshapes, which the
s2d contract of ``kernels/conv3x3.conv_s2d_b4_im2col`` needs.  A tensor
(B, H, W, C) becomes (B, H/b, W/b, b*b*C) with lane ((dy*b + dx)*C + c).
"""

from __future__ import annotations

import torch

__all__ = ["s2d", "d2s"]


def s2d(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/b, W/b, b*b*C)."""
    if b == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, b * b * c)


def d2s(x: torch.Tensor, b: int) -> torch.Tensor:
    """(B, H/b, W/b, b*b*C) -> (B, H, W, C)."""
    if b == 1:
        return x
    n, hb, wb, lanes = x.shape
    c = lanes // (b * b)
    x = x.reshape(n, hb, wb, b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hb * b, wb * b, c)
