"""Eval-time BatchNorm folding: each conv absorbs the BN affine after it.

In eval mode BN is the fixed affine ``(x - mu) * gamma / sqrt(var + eps) +
beta``; folding it into the conv before it (w' = w * s, b' = beta - mu * s,
with s = gamma / sqrt(var + eps)) gives conv + bias -> ReLU, as the JAX
package's ``models/fold_bn.py:fold_params``.  The folded weights are stored
once, contiguous HWIO in the compute dtype, which is the packed form the
3x3 kernel reads without a copy.  The attention conv of unet_sa has no BN
after it and stays as it is, as in the JAX package (``fold_bn.py:43``).
UNet++ folds every node's DoubleConv the same way.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..ops.nn import conv2d
from .blocks import DoubleConv

__all__ = ["FoldedDoubleConv", "fold_double_conv", "fold_bn", "serving_copy"]


class FoldedDoubleConv(nn.Module):
    """(conv3x3 + bias -> ReLU) x 2 with BN folded in; same call as DoubleConv."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            self.register_buffer(name, t.contiguous())

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        x = torch.relu(conv2d(x, self.w1, self.b1, padding=1, compute_dtype=compute_dtype))
        return torch.relu(conv2d(x, self.w2, self.b2, padding=1, compute_dtype=compute_dtype))


@torch.no_grad()
def fold_double_conv(dc: DoubleConv, dtype: Optional[torch.dtype] = None) -> FoldedDoubleConv:
    folded = []
    for i in (0, 3):
        conv, bn = dc.double_conv[i], dc.double_conv[i + 1]
        scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        w = conv.weight.permute(2, 3, 1, 0) * scale  # HWIO, scale over O
        b = bn.bias - bn.running_mean * scale
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        folded += [w, b]
    return FoldedDoubleConv(*folded)


def fold_bn(model: nn.Module, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """An eval copy of ``model`` with every DoubleConv folded.

    Raises KeyError when the model has no DoubleConv to fold.
    """
    folded = copy.deepcopy(model).eval()
    targets = [(parent, name, child)
               for parent in folded.modules()
               for name, child in parent.named_children()
               if isinstance(child, DoubleConv)]
    if not targets:
        raise KeyError("no DoubleConv (conv+bn) submodules to fold")
    for parent, name, child in targets:
        setattr(parent, name, fold_double_conv(child, dtype))
    return folded


def serving_copy(model: nn.Module, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The eval copy a model serves from: :func:`fold_bn`'s, or, for a model
    with no DoubleConv to fold (YOLOv8-seg, whose BN follows convs inside
    its CBS blocks), an eval copy that runs its BN live, as the JAX
    package's Predictor serves it (``engine/predict.py:127-133``)."""
    try:
        return fold_bn(model, dtype)
    except KeyError:
        return copy.deepcopy(model).eval()
