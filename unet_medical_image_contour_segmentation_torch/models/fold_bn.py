"""Eval-time BatchNorm folding: each conv absorbs the BN affine after it.

In eval mode BN is the fixed affine ``(x - mu) * gamma / sqrt(var + eps) +
beta``; folding it into the conv before it (w' = w * s, b' = beta - mu * s,
with s = gamma / sqrt(var + eps)) gives conv + bias -> ReLU, as the JAX
package's ``models/fold_bn.py:fold_params``.  The folded weights are stored
once, contiguous HWIO in the compute dtype, which is the packed form the
3x3 kernel reads without a copy.  The attention conv of unet_sa has no BN
after it and stays as it is, as in the JAX package (``fold_bn.py:43``).
UNet++ folds every node's DoubleConv the same way.  YOLOv8-seg folds each
CBS (conv + BN + SiLU) into conv + bias -> SiLU (:func:`fold_yolo`, JAX
``fold_yolo_params``); only its int8 path uses that fold, as in JAX: its
float serving keeps live BN (:func:`serving_copy`).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from ..ops.nn import conv2d
from .blocks import DoubleConv
from .yolov8_seg import CBS, silu_f32

__all__ = ["FoldedDoubleConv", "FoldedCBS", "fold_double_conv", "fold_bn", "fold_yolo",
           "fold_for_quantize", "serving_copy"]


class FoldedDoubleConv(nn.Module):
    """(conv3x3 + bias -> ReLU) x 2 with BN folded in; same call as DoubleConv
    (``group`` is unused: a folded block has no batch statistics).  Each
    bias and ReLU is one pass (``kernels/bias_relu.py``)."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
            self.register_buffer(name, t.contiguous())

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        kw = dict(padding=1, compute_dtype=compute_dtype, shard=shard, relu=True)
        x = conv2d(x, self.w1, self.b1, **kw)
        return conv2d(x, self.w2, self.b2, **kw)


class FoldedCBS(nn.Module):
    """conv (HWIO ``w``, bias ``b``, stride, pad k // 2) -> SiLU, BN folded in;
    same call as CBS."""

    def __init__(self, w, b, stride: int):
        super().__init__()
        self.stride = stride
        self.register_buffer("w", w.contiguous())
        self.register_buffer("b", b.contiguous())

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        y = conv2d(x, self.w, self.b, stride=self.stride, padding=self.w.shape[0] // 2,
                   compute_dtype=compute_dtype, shard=shard)
        return silu_f32(y)


def _scale(bn: nn.BatchNorm2d) -> torch.Tensor:
    return bn.weight / torch.sqrt(bn.running_var + bn.eps)


@torch.no_grad()
def fold_double_conv(dc: DoubleConv, dtype: Optional[torch.dtype] = None) -> FoldedDoubleConv:
    folded = []
    for i in (0, 3):
        conv, bn = dc.double_conv[i], dc.double_conv[i + 1]
        scale = _scale(bn)
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


@torch.no_grad()
def fold_yolo(model: nn.Module, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """An eval copy of ``model`` with every CBS folded into a
    :class:`FoldedCBS` (JAX ``fold_yolo_params``: w' = w * s, b' = beta - mu
    * s); the ConvTranspose ups and the head stay as they are.

    Raises KeyError when the model has no CBS to fold.
    """
    folded = copy.deepcopy(model).eval()
    targets = [(parent, name, child)
               for parent in folded.modules()
               for name, child in parent.named_children()
               if isinstance(child, CBS)]
    if not targets:
        raise KeyError("no CBS (conv+bn) submodules to fold")
    for parent, name, cbs in targets:
        scale = _scale(cbs.bn)
        w = cbs.conv.weight.permute(2, 3, 1, 0) * scale
        b = cbs.bn.bias - cbs.bn.running_mean * scale
        if dtype is not None:
            w, b = w.to(dtype), b.to(dtype)
        setattr(parent, name, FoldedCBS(w, b, cbs.stride))
    return folded


def fold_for_quantize(model: nn.Module) -> nn.Module:
    """The f32 fold the int8 path quantises (JAX ``fold_for_quantize``):
    :func:`fold_bn`'s, or :func:`fold_yolo`'s for a model with no
    DoubleConv.  Raises KeyError when neither folds anything."""
    try:
        return fold_bn(model, torch.float32)
    except KeyError:
        return fold_yolo(model, torch.float32)


def serving_copy(model: nn.Module, dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The eval copy a model serves from: :func:`fold_bn`'s, or, for a model
    with no DoubleConv to fold (YOLOv8-seg, whose BN follows convs inside
    its CBS blocks), an eval copy that runs its BN live, as the JAX
    package's Predictor serves it (``engine/predict.py:127-133``)."""
    try:
        return fold_bn(model, dtype)
    except KeyError:
        return copy.deepcopy(model).eval()
