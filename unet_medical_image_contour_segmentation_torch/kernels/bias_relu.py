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
Tensor`` (functional: it mutates nothing): its CUDA implementation is the
ctypes launch and the launch counter ``bias_relu_nhwc.launches``, its CPU
implementation the plain version, and its fake implementation the output's
shape and dtype, so ``torch.export`` traces through it and an exported
program launches the same pass.  :func:`bias_relu_nhwc` checks its operands
first; :data:`op` is the operator unchecked, for a caller that guarantees
them, as ``ops/nn.py:conv2d`` does on the served forward's hot path (18
calls a forward).  The channel count's range is the C side's to check: it
returns ``cudaErrorInvalidValue`` past the bias it can stage.

The operator is registered with ``torch.library``'s ``define`` / ``impl``
rather than ``custom_op`` as ``umics::conv3x3_nhwc`` is: ``custom_op``
wraps each implementation in ``torch._disable_dynamo``, whose first call
imports ``torch._dynamo`` (on the H100's host about 3.5 s more set-up for
the served full UNet, which runs no other custom op), and its dispatch
costs about 12 µs more a call on a CPU host, 18 calls a forward.
"""

from __future__ import annotations

import ctypes

import torch

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


def _launch(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/bias_relu.cu on the caller's stream -> the output."""
    out = torch.empty_like(y)
    fn = _LAUNCH.get(y.dtype) or _library()[y.dtype]
    # the device guard is the C side's; the raw stream skips building a
    # torch.cuda.Stream a call (the launch's host cost is this function's)
    dev = y.get_device()
    err = fn(y.data_ptr(), b.data_ptr(), out.data_ptr(), y.numel(), y.shape[3], dev,
             torch._C._cuda_getCurrentRawStream(dev))
    if err:
        raise RuntimeError(f"bias_relu_nhwc launch of {tuple(y.shape)} failed: "
                           f"{_error_string(err)} ({err})")
    return out


def _forward(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: one launch, counted."""
    out = _launch(y, b)
    bias_relu_nhwc.launches += 1
    return out


def _fake(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(y)


_LIB = torch.library.Library("umics", "FRAGMENT")  # held: the registrations live with it
_LIB.define("bias_relu_nhwc(Tensor y, Tensor b) -> Tensor")
_LIB.impl("bias_relu_nhwc", _forward, "CUDA")
_LIB.impl("bias_relu_nhwc", bias_relu_nhwc_reference, "CPU")
torch.library.register_fake("umics::bias_relu_nhwc", _fake, lib=_LIB)
op = torch.ops.umics.bias_relu_nhwc.default


def bias_relu_nhwc(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.relu(y + b)`` for contiguous (B, H, W, C) ``y`` and a bias of C,
    both bf16 or both f32 -> (B, H, W, C) in y's dtype.  A CUDA tensor takes
    one launch of the pass (and adds one to ``bias_relu_nhwc.launches``), a
    CPU tensor the plain version (both through ``umics::bias_relu_nhwc``,
    :data:`op`, after checking the operands)."""
    _check(y, b)
    return op(y, b)


bias_relu_nhwc.launches = 0


_LAUNCH: dict = {}  # dtype -> the library's launch function, filled by the first launch


def _library() -> dict:
    """Build (a checkout's first call) and load csrc/bias_relu.cu -> _LAUNCH."""
    from ._build import load_library

    lib = load_library("bias_relu")
    ptr = ctypes.c_void_p
    for fn in (lib.bias_relu_nhwc_bf16, lib.bias_relu_nhwc_f32):
        fn.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
        fn.restype = ctypes.c_int
    lib.bias_relu_error_string.argtypes = [ctypes.c_int]
    lib.bias_relu_error_string.restype = ctypes.c_char_p
    _LAUNCH.update({torch.bfloat16: lib.bias_relu_nhwc_bf16,
                    torch.float32: lib.bias_relu_nhwc_f32})
    return _LAUNCH


def _error_string(err: int) -> str:
    from ._build import load_library

    return load_library("bias_relu").bias_relu_error_string(err).decode()
