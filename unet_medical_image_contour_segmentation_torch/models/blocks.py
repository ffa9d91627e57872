"""UNet building blocks as ``nn.Module``s over NHWC activations.

The blocks of the JAX package's ``models/blocks.py``: DoubleConv ((3x3 conv
without bias -> BN -> ReLU) x 2, optional mid width), Down (2x2 max pool then
DoubleConv), SpatialAttention (channel mean and max -> 7x7 conv without bias
-> sigmoid), Up (ConvTranspose k2 s2, or a x2 bilinear upsample with
``align_corners=True`` and a DoubleConv with mid = in // 2; asymmetric pad to
the skip's size, the attention gate on the skip when asked, concat
``[skip, up]``, DoubleConv) and OutConv (1x1 conv with bias).

Parameters sit in ``nn.Conv2d`` / ``nn.BatchNorm2d`` / ``nn.ConvTranspose2d``
holders named like the reference model, so its state_dict keys
(``inc.double_conv.{0,1,3,4}``, ``down{i}.maxpool_conv.1.double_conv``,
``up{i}.up``, ``up{i}.attention.conv1``, ``up{i}.conv.double_conv``,
``outc.conv``) load with a plain
``load_state_dict``; their torch default initialisers are the JAX package's.
The forward passes go through ``ops.nn`` on NHWC tensors, never through the
holders' own NCHW ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import batch_norm, conv2d, conv_transpose2d, max_pool2d
from ..ops.resize import upsample_x2_align_corners

__all__ = ["DoubleConv", "Down", "SpatialAttention", "Up", "OutConv"]


def _conv_hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO


def _bn_apply(bn: nn.BatchNorm2d, y: torch.Tensor, train: bool) -> torch.Tensor:
    """BN over NHWC ``y``; in train mode the running statistics and
    ``num_batches_tracked`` move in place, except while a rematerialised
    block recomputes its forward in the backward pass (``bn.recomputing``,
    set by ``models/unet.py``): the step's forward already moved them once."""
    y, (mean, var) = batch_norm(y, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                train=train, momentum=bn.momentum, eps=bn.eps)
    if train and not getattr(bn, "recomputing", False):
        with torch.no_grad():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)
            bn.num_batches_tracked += 1
    return y


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, cmid: Optional[int] = None):
        super().__init__()
        cmid = cmid or cout
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cmid, 3, padding=1, bias=False),
            nn.BatchNorm2d(cmid),
            nn.ReLU(inplace=True),
            nn.Conv2d(cmid, cout, 3, padding=1, bias=False),
            nn.BatchNorm2d(cout),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        for i in (0, 3):
            conv, bn = self.double_conv[i], self.double_conv[i + 1]
            y = conv2d(x, _conv_hwio(conv), padding=1, compute_dtype=compute_dtype)
            x = torch.relu(_bn_apply(bn, y, self.training))
        return x


class Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        return self.maxpool_conv[1](max_pool2d(x, 2), compute_dtype)


def _pad_to_match(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Asymmetric zero pad of NHWC x1 to x2's spatial size."""
    dh = x2.shape[1] - x1.shape[1]
    dw = x2.shape[2] - x1.shape[2]
    if dh == 0 and dw == 0:
        return x1
    return F.pad(x1, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def attention_gate(x: torch.Tensor, w: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The spatial attention gate of x for the HWIO (k, k, 2, 1) weight ``w``
    (JAX ``blocks.py:spatial_attention_apply``): channel mean and max in
    f32, a kxk SAME conv without bias in the compute dtype, the sigmoid in
    f32, cast to x's dtype."""
    xf = x.float()
    feats = torch.cat([xf.mean(dim=-1, keepdim=True), xf.amax(dim=-1, keepdim=True)],
                      dim=-1).to(x.dtype)
    att = conv2d(feats, w, padding=w.shape[0] // 2, compute_dtype=compute_dtype)
    return torch.sigmoid(att.float()).to(x.dtype)


class SpatialAttention(nn.Module):
    """A gate in (0, 1) per pixel from the channel mean and max
    (:func:`attention_gate`)."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2, bias=False)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        return attention_gate(x, _conv_hwio(self.conv1), compute_dtype)


class Up(nn.Module):
    """x2 upsample of x1 (ConvTranspose, or bilinear with ``align_corners=True``),
    the attention gate on the skip x2 if asked, concat ``[x2, x1]``, DoubleConv."""

    def __init__(self, cin: int, cout: int, bilinear: bool = False,
                 attention: bool = False):
        super().__init__()
        self.bilinear = bilinear
        if bilinear:
            self.conv = DoubleConv(cin, cout, cin // 2)
        else:
            self.up = nn.ConvTranspose2d(cin, cin // 2, kernel_size=2, stride=2)
            self.conv = DoubleConv(cin, cout)
        if attention:
            self.attention = SpatialAttention()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None):
        if self.bilinear:
            x1 = upsample_x2_align_corners(x1)
        else:
            # (in, out, kh, kw) -> HWIO with I = in
            x1 = conv_transpose2d(x1, self.up.weight.permute(2, 3, 0, 1), self.up.bias,
                                  stride=2, compute_dtype=compute_dtype)
        x1 = _pad_to_match(x1, x2)
        if hasattr(self, "attention"):
            x2 = x2 * self.attention(x2, compute_dtype)
        return self.conv(torch.cat([x2, x1.to(x2.dtype)], dim=-1), compute_dtype)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size=1)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        return conv2d(x, _conv_hwio(self.conv), self.conv.bias, compute_dtype=compute_dtype)
