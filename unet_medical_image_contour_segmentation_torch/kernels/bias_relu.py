"""Bias add and ReLU of a conv's NHWC output in one hand-written pass.

``bias_relu_nhwc(y, b)`` is ``torch.relu(y + b)`` for a (B, H, W, C) ``y``
and a bias of C in y's dtype: the sum in f32, rounded once to y's dtype,
then ``max(., 0)``, NaN passed on.  On the card it is one launch of
``csrc/bias_relu.cu``, which gives the same bits as PyTorch's two passes
while it reads and writes the tensor once each; on the CPU it is that
plain expression.  The BN-folded DoubleConv of the served UNets and UNet++
(``models/fold_bn.py``) runs it after each 3x3 conv, through
``ops/nn.py:conv2d(..., relu=True)``.

It replaces no TPU kernel: XLA fuses the bias and the ReLU into the conv
there.  The pass is bound by bytes; its design is in the source's header.

The pass is the operator ``umics::bias_relu_nhwc(Tensor y, Tensor b) ->
Tensor`` (functional: it mutates nothing), declared through the kernels'
one seam (``_build.py``): on CUDA tensors one launch, counted as
``LAUNCHES["bias_relu_nhwc"]``, on CPU tensors the plain version, under
fake tensors the output's shape and dtype, so ``torch.export`` traces
through it and an exported program launches the same pass.
:func:`bias_relu_nhwc` checks its operands first; :data:`op` is the
operator unchecked, for a caller that guarantees them, as
``ops/nn.py:conv2d`` does on the served forward's hot path (18 calls a
forward).  The channel count's range is the C side's to check: it returns
``cudaErrorInvalidValue`` past the bias it can stage.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary, register_op

__all__ = ["bias_relu_nhwc", "bias_relu_nhwc_reference", "op"]

_DTYPES = (torch.bfloat16, torch.float32)


def bias_relu_nhwc_reference(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version: ``torch.relu(y + b)`` with b cast to y's dtype."""
    return torch.relu(y + b.to(y.dtype))


def _check(y: torch.Tensor, b: torch.Tensor) -> None:
    if y.dim() != 4 or b.dim() != 1 or b.shape[0] != y.shape[3]:
        raise ValueError(f"want y (B, H, W, C) and a bias of C; got {tuple(y.shape)} and "
                         f"{tuple(b.shape)}")
    if y.dtype not in _DTYPES or b.dtype != y.dtype:
        raise TypeError(f"y and b must share one dtype of {_DTYPES}; got {y.dtype} and {b.dtype}")
    if y.device != b.device:
        raise ValueError(f"y on {y.device}, b on {b.device}")
    if not y.is_contiguous() or not b.is_contiguous():
        raise ValueError("y must be contiguous NHWC and b contiguous")


_P, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURE = ([_P, _P, _P, ctypes.c_longlong, _I32, _I32, _P], _I32)
_CSRC = KernelLibrary("bias_relu", bias_relu_nhwc_bf16=_SIGNATURE, bias_relu_nhwc_f32=_SIGNATURE)
_ENTRY = {torch.bfloat16: "bias_relu_nhwc_bf16", torch.float32: "bias_relu_nhwc_f32"}


def _launch(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/bias_relu.cu -> the output."""
    out = torch.empty_like(y)
    _CSRC.launch(_ENTRY[y.dtype], y, y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(),
                 y.shape[3])
    return out


def _fake(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(y)


op = register_op("bias_relu_nhwc(Tensor y, Tensor b) -> Tensor", _launch,
                 cpu=bias_relu_nhwc_reference, fake=_fake)


def bias_relu_nhwc(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.relu(y + b)`` for contiguous (B, H, W, C) ``y`` and a bias of C,
    both bf16 or both f32 -> (B, H, W, C) in y's dtype.  A CUDA tensor takes
    one launch of the pass, a CPU tensor the plain version (both through
    ``umics::bias_relu_nhwc``, :data:`op`, after checking the operands)."""
    _check(y, b)
    return op(y, b)
