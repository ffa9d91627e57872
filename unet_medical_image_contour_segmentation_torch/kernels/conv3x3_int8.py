"""int8 3x3 stride-1 SAME convolution, NHWC, with the int8 serving path's
requant / dequant epilogue fused in, as a hand-written Hopper kernel.

Replaces XLA ops of the JAX package, not a Pallas kernel: the int8 x int8 ->
int32 convolution ``ops/wide.py:conv_wide_int8`` (:255-307), its split-input
form ``conv_wide_split_int8`` (:309-326; the port concatenates the int8
parts first, which is exact in integers) and the epilogue of
``models/quantize.py:_qconv`` (:65-82).  For one input::

    acc = conv3x3(x, w)                      int32, exact
    yf  = max(f32(acc) * mul + badd, 0)      a multiply, then an add, in f32
    y   = clip(round_half_even(yf), 0, 127)  int8     (out_dtype int8: requant)
        = yf                                 f32/bf16 (otherwise: dequant)

Bound: bytes at most of unet_s's levels (int8 activations in and out), the
operations at the deep ones (Cin >= 64 at <= 64^2) at the H100's 1,979 TOPS
int8.  The design (``csrc/conv3x3_int8.cu``): an implicit GEMM on
``mma.sync.m16n8k32`` s8 with s32 sums, an 8x32 pixel tile and up to 64
output channels a block, K walked in chunks of 32 input channels x 9 taps,
double-buffered 16-byte ``cp.async`` staging with zero fill (the wrapper
pads Cin to a multiple of 16 with zero channels: inc.conv1's 1 to 16), the
epilogue on the s32
registers with ``__fmul_rn`` / ``__fadd_rn`` (no FMA contraction) and
``__float2int_rn`` (round half to even, ``torch.round``'s rule).

The weight is packed once, when the int8 parameters are built
(:func:`pack_weight`): (Cout, 9 * Cin_p) int8, K-major per output channel,
Cin_p = Cin rounded up to 32 with zeros.  PyTorch has no int8 convolution on
CUDA, so the plain version (:func:`conv3x3_int8_reference`) sums the im2col
patch times the packed weight in float64 (exact: |acc| <= 9 * 1024 * 127^2 <
2^53) and casts to int32.  The wrapper runs it for a CPU tensor; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .conv3x3 import _patches

__all__ = [
    "CIN_CHUNK",
    "conv3x3_int8",
    "conv3x3_int8_reference",
    "conv3x3_int8_sums",
    "epilogue",
    "pack_weight",
]

CIN_CHUNK = 32                 # input channels per K step of the kernel
_GRID_MAX = 65535              # gridDim.y and gridDim.z
_OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
# the patch rows the plain version multiplies at once (float64: 8 bytes each)
_REFERENCE_ROWS = 1 << 20


def _cin_padded(cin: int) -> int:
    return -(-cin // CIN_CHUNK) * CIN_CHUNK


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 HWIO (3, 3, Cin, Cout) -> the kernel's (Cout, 9 * Cin_p) int8,
    element [co, (u*3 + v) * Cin_p + ci], zeros for ci >= Cin."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.dtype != torch.int8:
        raise ValueError(f"want an int8 (3, 3, Cin, Cout) weight, got {w.dtype} "
                         f"{tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    out = torch.zeros((cout, 9, _cin_padded(cin)), dtype=torch.int8, device=w.device)
    out[:, :, :cin] = w.reshape(9, cin, cout).permute(2, 0, 1)
    return out.reshape(cout, -1)


def _check(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    if x.dim() != 4 or x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int8 (B, H, W, Cin) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    cin = x.shape[3]
    if (wp.dim() != 2 or wp.dtype != torch.int8 or not wp.is_contiguous()
            or wp.shape[1] != 9 * _cin_padded(cin)):
        raise ValueError(f"w must be pack_weight's contiguous int8 (Cout, 9 * {_cin_padded(cin)}) "
                         f"for Cin = {cin}, got {wp.dtype} {tuple(wp.shape)}")
    cout = wp.shape[0]
    for name, t in (("mul", mul), ("badd", badd)):
        if t.shape != (cout,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 ({cout},) tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be one of {tuple(_OUT_KIND)}, not {out_dtype}")
    if len({x.device, wp.device, mul.device, badd.device}) != 1:
        raise ValueError("x, w, mul and badd must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_int8 runs on cuda or cpu, not {x.device}")


def epilogue(acc: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """int32 sums -> the requant (int8) or dequant (f32/bf16) output: the
    multiply and the add as two f32 roundings, ReLU, then round half to even
    and clip to [0, 127] for int8."""
    yf = torch.clamp_min(acc.float() * mul + badd, 0.0)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(yf), 0, 127).to(torch.int8)
    return yf.to(out_dtype)


def conv3x3_int8_sums(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The plain int32 sums: the (B, H, W, 9*Cin) im2col patch times the
    packed weight in float64 (exact), cast to int32, over a few images at a
    time so that the patch's memory stays bounded."""
    b, h, w, cin = x.shape
    cout = wp.shape[0]
    wmat = wp.reshape(cout, 9, -1)[:, :, :cin].reshape(cout, 9 * cin).double().T
    acc = torch.empty((b, h, w, cout), dtype=torch.int32, device=x.device)
    step = max(1, _REFERENCE_ROWS // (h * w))
    for i in range(0, b, step):
        acc[i:i + step] = (_patches(x[i:i + step]).double() @ wmat).to(torch.int32)
    return acc


def conv3x3_int8_reference(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor,
                           badd: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The plain version: :func:`conv3x3_int8_sums`, then :func:`epilogue`."""
    _check(x, wp, mul, badd, out_dtype)
    return epilogue(conv3x3_int8_sums(x, wp), mul, badd, out_dtype)


def _launch(x, wp, mul, badd, out_dtype) -> torch.Tensor:
    b, h, w, cin = x.shape
    cout = wp.shape[0]
    # the kernel stages 16-byte pieces of a pixel: Cin a multiple of 16 and an
    # aligned base.  Zero channels meet the packed weight's zero rows.
    pad = -cin % 16
    if pad or x.data_ptr() % 16:
        x = F.pad(x, (0, pad)) if pad else x.clone()
    nt = next(n for n in (1, 2, 4, 8) if 8 * n >= min(cout, 64))
    grid_yz = (-(-h // 8), b * -(-cout // (8 * nt)))
    if max(grid_yz) > _GRID_MAX:
        raise ValueError(f"shape {tuple(x.shape)} -> {cout} exceeds the launch grid {grid_yz}")
    y = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_int8_nhwc(x.data_ptr(), wp.data_ptr(), mul.data_ptr(),
                                    badd.data_ptr(), y.data_ptr(), b, h, w, cin + pad, cout,
                                    _OUT_KIND[out_dtype], stream)
    if err:
        raise RuntimeError(f"conv3x3_int8 launch failed: "
                           f"{lib.conv3x3_int8_error_string(err).decode()} ({err})")
    return y


def conv3x3_int8(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
                 out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """x: contiguous int8 (B, H, W, Cin); wp: :func:`pack_weight` of the int8
    HWIO weight; mul, badd: f32 (Cout,) -> (B, H, W, Cout) in ``out_dtype``:
    int8 requantised, or f32 / bf16 dequantised (see the module docstring).

    A CUDA tensor launches ``csrc/conv3x3_int8.cu`` (and adds one to
    ``conv3x3_int8.launches``); a CPU tensor runs the plain version."""
    _check(x, wp, mul, badd, out_dtype)
    if x.device.type == "cpu":
        return conv3x3_int8_reference(x, wp, mul, badd, out_dtype)
    y = _launch(x, wp, mul, badd, out_dtype)
    conv3x3_int8.launches += 1
    return y


conv3x3_int8.launches = 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("conv3x3_int8")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_int8_nhwc.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
    lib.conv3x3_int8_nhwc.restype = i32
    lib.conv3x3_int8_error_string.argtypes = [i32]
    lib.conv3x3_int8_error_string.restype = ctypes.c_char_p
    return lib

