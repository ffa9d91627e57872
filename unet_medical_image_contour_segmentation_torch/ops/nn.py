"""Core NN primitives over NHWC activations, as the JAX package's ``ops/nn.py``.

Public layouts are the JAX package's: activations NHWC, conv weights HWIO,
transpose-conv weights HWIO with I = the transpose conv's input channels.
Inside, a NHWC tensor is handed to ``torch.nn.functional`` as
``x.permute(0, 3, 1, 2)``, a channels_last view that costs no copy.

Mixed precision follows the JAX rules: with ``compute_dtype`` set, a conv
casts x and w to it, sums in f32 and rounds its output to that dtype, and a
bias is added afterwards in the output dtype; BatchNorm always computes in
f32 and casts back.

:func:`conv2d` sends every conv that ``kernels.conv3x3.supported`` accepts
(3x3, stride 1, pad 1, 8 <= Cin <= 32) to :func:`kernels.conv3x3.conv3x3_nhwc`,
the port of the repo's one TPU kernel; the others go to ``F.conv2d``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import conv3x3

__all__ = [
    "conv2d",
    "conv_transpose2d",
    "max_pool2d",
    "batch_norm",
    "BN_EPS",
    "BN_MOMENTUM",
]

# torch.nn.BatchNorm2d defaults (used by every BN in the model)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding: int = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC.  Matches torch.nn.Conv2d."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    if conv3x3.supported(w.shape, stride, padding):
        y = conv3x3.conv3x3_nhwc(x.contiguous(), w)
    else:
        y = _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=padding))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def conv_transpose2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    stride: int = 2,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """torch.nn.ConvTranspose2d(kernel_size=k, stride=s) over NHWC.

    ``w`` is HWIO with I = input and O = output channels of the transpose
    conv (torch's (in, out, kh, kw) is ``w.permute(2, 3, 0, 1)``).
    """
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    y = _nhwc(F.conv_transpose2d(_nchw(x), w.permute(2, 3, 0, 1), stride=stride))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def max_pool2d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """MaxPool2d(window), stride == window, floor mode: trailing rows and
    columns that do not fill a window are dropped."""
    return _nhwc(F.max_pool2d(_nchw(x), window))


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    train: bool,
    momentum: float = BN_MOMENTUM,
    eps: float = BN_EPS,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm2d over NHWC channels with torch semantics, computed in f32.

    Returns ``(y, (new_running_mean, new_running_var))``.  Train mode
    normalises with the biased batch variance and moves the running variance
    towards the unbiased one (torch's rule); eval mode uses the running stats.
    """
    xf = x.float()
    if train:
        var, mean = torch.var_mean(xf, dim=(0, 1, 2), unbiased=False)
        n = x.shape[0] * x.shape[1] * x.shape[2]
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean.float(), running_var.float()
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean) * inv + bias.float()
    return y.to(x.dtype), (new_mean, new_var)
