"""Core NN primitives over NHWC activations, as the JAX package's ``ops/nn.py``.

Public layouts are the JAX package's: activations NHWC, conv weights HWIO,
transpose-conv weights HWIO with I = the transpose conv's input channels.
Inside, a NHWC tensor is handed to ``torch.nn.functional`` as
``x.permute(0, 3, 1, 2)``, a channels_last view that costs no copy.

Mixed precision follows the JAX rules: with ``compute_dtype`` set, a conv
casts x and w to it, sums in f32 and rounds its output to that dtype, and a
bias is added afterwards in the output dtype; BatchNorm always computes in
f32 and casts back; with a process ``group`` its train-mode statistics are
the whole group's batch (cross-replica BN, ``ops/collectives.py``).

:func:`conv2d` sends every conv that ``kernels.conv3x3.supported`` accepts
(3x3, stride 1, pad 1, 8 <= Cin <= 32) to :func:`kernels.conv3x3.conv3x3_nhwc`,
the port of the repo's one TPU kernel; the others go to ``F.conv2d``.  With
``relu=True``, the bias add and the ReLU run as one pass,
:func:`kernels.bias_relu.bias_relu_nhwc`, on the conv's whole output.

Given a ``shard`` (``ops/halo.py``: x is one band of rows of the images), a
padded conv exchanges a halo of ``padding`` rows.  At stride 1 it runs the
same SAME conv on the band and its halo and drops the first and last
``padding`` output rows, so a 3x3 conv still meets the dispatch rule and
runs the hand kernel, at (B, h + 2, W, Cin).  At stride 2 the whole
images' output row i reads input rows 2i - p .. 2i + p, so a band that
starts at an even row needs ``padding`` rows above it: the conv runs on
the band and its halo with no H padding and gives exactly the band's h / 2
output rows (the bottom halo rows are read by no output; they are
exchanged all the same, one code path, and take a zero gradient).  A
SAME conv with rows dropped would centre its outputs on odd rows.
:func:`conv_transpose2d` (k2 s2), the 1x1 convs and :func:`max_pool2d` (on
bands of even height) are row-local.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import bias_relu, conv3x3
from .collectives import pmean, world_size
from .halo import Shard, halo_exchange

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
    shard: Optional[Shard] = None,
    relu: bool = False,
) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC.  Matches torch.nn.Conv2d; on a
    ``shard``'s band of rows, that conv of the whole images (a kxk conv of
    padding k // 2, stride 1 or 2).  ``relu``: ``torch.relu`` of the result,
    the bias add and the ReLU in one pass (``b`` required)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    halo = padding if shard is not None else 0
    if halo:
        if stride not in (1, 2) or tuple(w.shape[:2]) != (2 * halo + 1, 2 * halo + 1):
            raise ValueError(f"a row-sharded conv must be a SAME conv of stride 1 or 2, not a "
                             f"{tuple(w.shape[:2])} kernel at stride {stride}, padding {padding}")
        x = halo_exchange(x, shard, halo)
    if conv3x3.supported(w.shape, stride, padding):
        y = conv3x3.conv3x3_nhwc(x.contiguous(), w)
    else:
        pad = (0, padding) if halo and stride == 2 else padding
        y = _nhwc(F.conv2d(_nchw(x), w.permute(3, 2, 0, 1), stride=stride, padding=pad))
    if relu:
        if b is None:
            raise ValueError("relu=True runs the bias add and the ReLU as one pass: give b")
        # on the whole output, a shard's halo rows too: they are exact, and
        # the pass reads one contiguous tensor; the operands are the op's as
        # it wants them, so it runs unchecked
        y = bias_relu.op(y.contiguous(), b.to(y.dtype))
    if halo and stride == 1:
        y = y[:, halo:-halo]
    if b is not None and not relu:
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
    group=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """BatchNorm2d over NHWC channels with torch semantics, computed in f32.

    Returns ``(y, (new_running_mean, new_running_var))``.  Train mode
    normalises with the biased batch variance and moves the running variance
    towards the unbiased one (torch's rule); eval mode uses the running stats.

    Train mode takes JAX's one-pass statistics: the per-channel mean and
    mean of squares, and the variance ``mean_sq - mean**2``.  With a
    ``group`` (a ``torch.distributed`` process group; None is one device)
    both means and the element count are the whole group's, as the JAX
    ``batch_norm`` takes them under ``axis_name`` (``pmean`` of both,
    ``n * psum(1)``), through one differentiable all-reduce; a group of one
    rank computes what one device does, bit for bit.  (In bf16 the one-pass
    variance is as good as torch's two-pass one: ``chip_smoke.py``'s A0.)
    """
    xf = x.float()
    if train:
        n = x.shape[0] * x.shape[1] * x.shape[2] * world_size(group)
        local = torch.stack([xf.mean(dim=(0, 1, 2)), xf.square().mean(dim=(0, 1, 2))])
        mean, mean_sq = pmean(local, group)
        var = mean_sq - mean.square()
        unbiased = var * (n / max(n - 1, 1))
        new_mean = (1.0 - momentum) * running_mean + momentum * mean
        new_var = (1.0 - momentum) * running_var + momentum * unbiased
    else:
        mean, var = running_mean.float(), running_var.float()
        new_mean, new_var = running_mean, running_var
    inv = torch.rsqrt(var + eps) * scale.float()
    y = (xf - mean) * inv + bias.float()
    return y.to(x.dtype), (new_mean, new_var)
