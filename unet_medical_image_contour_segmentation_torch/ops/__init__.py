"""NHWC primitives: convs (with the 3x3 kernel dispatch), pooling, BN, resize."""

from .nn import batch_norm, conv2d, conv_transpose2d, max_pool2d
from .resize import bilinear_resize, upsample_x2_align_corners

__all__ = [
    "batch_norm",
    "conv2d",
    "conv_transpose2d",
    "max_pool2d",
    "bilinear_resize",
    "upsample_x2_align_corners",
]
