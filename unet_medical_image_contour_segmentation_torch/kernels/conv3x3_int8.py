"""int8 3x3 stride-1 SAME convolution, NHWC, with the int8 serving path's
requant / dequant epilogue fused in, as a hand-written Hopper kernel.

Replaces XLA ops of the JAX package, not a Pallas kernel: the int8 x int8 ->
int32 convolution ``ops/wide.py:conv_wide_int8`` (:255-307), its split-input
form ``conv_wide_split_int8`` (:309-326; here the optional second input
``x2``, summed in the same K walk) and the epilogues of
``models/quantize.py:_qconv`` (:65-82, ``act="relu"``) and of
``_forward_yolo``'s CBS (:374-392, ``act="silu"``).  For the input xc = x,
or the channel concatenation [x, x2]::

    acc = conv3x3(xc, w)                     int32, exact
    z   = f32(acc) * mul + badd              a multiply, then an add, in f32
    relu:
    yf  = max(z, 0)
    y   = clip(round_half_even(yf), 0, 127)  int8     (out_dtype int8: requant)
        = yf                                 f32/bf16 (otherwise: dequant)
    silu (z at true scale):
    yf  = z * sigmoid(z)                     torch.sigmoid's f32, then a multiply
    y   = clip(round_half_even(yf * inv_s), -127, 127)   int8 (requant)
        = yf                                 f32/bf16 (dequant)

Bound: bytes at most of unet_s's levels (int8 activations in and out), the
operations at the deep ones (Cin >= 64 at <= 64^2) at the H100's 1,979 TOPS
int8.  The design (``csrc/conv3x3_int8.cu``): ``wgmma`` m64nNk32 s8 with s32
sums, one block over all of Cout up to 256 (N = Cout rounded up to 16, 32,
64, 128 or 256), the halo and the weight staged by TMA into a ring of
mbarrier-tracked stages by a producer warp for two consumer warpgroups, a
persistent grid of about one block per SM over (b, row block, column block)
tiles of :func:`launch_geometry`, the epilogue through shared memory out in
16-byte stores, with ``__fmul_rn`` / ``__fadd_rn`` (no FMA contraction) and
``__float2int_rn`` (round half to even, ``torch.round``'s rule).  Cin < 16
(inc.conv1's 1) takes a second kernel that reads x as it is and folds the
taps into K (im2col in shared memory); other Cin that are not multiples of
16 (TMA's stride rule) are padded with zero channels here.

The weight is packed once, when the int8 parameters are built
(:func:`pack_weight`), in the order the kernel stages it: per 256-channel
Cout piece and 32-channel K chunk, 9 taps x 2 halves of 16-byte rows, one
row per output channel (K-major), zeros past Cin and Cout;
:func:`weight_matrix` gives it back as (Cout, 9 * Cin_p).  PyTorch has no int8
convolution on CUDA, so the plain version (:func:`conv3x3_int8_reference`)
sums the im2col patch times the packed weight in float64 (exact: |acc| <= 9
* 1024 * 127^2 < 2^53) and casts to int32.  The wrapper runs it for a CPU
tensor; a CUDA tensor launches the kernel or raises.  Both go through the
operator ``umics::conv3x3_int8``, declared through the kernels' one seam
(``_build.py``; ``out_dtype`` and the optional ``x2`` are in its schema,
its fake implementation gives the output's shape and dtype, and a launch
is counted as ``LAUNCHES["conv3x3_int8"]``), which ``torch.export`` traces
through for the exported int8 program (``engine/export.py``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import KernelLibrary, register_op
from .conv3x3 import _patches

__all__ = [
    "CIN_CHUNK",
    "Geometry",
    "kernel_geometry",
    "launch_geometry",
    "conv3x3_int8",
    "conv3x3_int8_reference",
    "conv3x3_int8_sums",
    "epilogue",
    "pack_weight",
    "weight_matrix",
]

CIN_CHUNK = 32                 # input channels per K step of the kernel
SMEM_MAX = 232_448             # dynamic shared memory a block may use on sm_90
H100_SMS = 132
_OUT_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_ACT = {"relu": 0, "silu": 1}
# the patch rows the plain version multiplies at once (float64: 8 bytes each)
_REFERENCE_ROWS = 1 << 20


def _cin_padded(cin: int) -> int:
    return -(-cin // CIN_CHUNK) * CIN_CHUNK


def _rows_for(cout: int) -> int:
    """Weight rows of one Cout piece in the pack: Cout itself up to 256, else 256."""
    return min(cout, _N_MAX)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """int8 HWIO (3, 3, Cin, Cout) -> the kernel's (pieces, chunks, 9, 2, rows,
    16) int8: for Cout piece p (of 256 channels) and K chunk c (of 32 input
    channels), tap t and 16-channel half j, the 16-byte rows of output
    channels p * 256 + n, element [p, c, t, j, n, e] = w[t, 32 c + 16 j + e,
    p * 256 + n]; rows = Cout up to 256 (else 256, the last piece padded),
    zeros past Cin and Cout.  Each (piece, chunk) is one contiguous run of
    288 * rows bytes in the order the kernel stages it (one bulk copy)."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.dtype != torch.int8:
        raise ValueError(f"want an int8 (3, 3, Cin, Cout) weight, got {w.dtype} "
                         f"{tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    cin_p, rows = _cin_padded(cin), _rows_for(cout)
    pieces = -(-cout // rows)
    full = torch.zeros((9, cin_p, pieces * rows), dtype=torch.int8, device=w.device)
    full[:, :cin, :cout] = w.reshape(9, cin, cout)
    # full[t, 32 c + 16 j + e, p * rows + n] -> [p, c, t, j, n, e]
    return (full.reshape(9, cin_p // CIN_CHUNK, 2, 16, pieces, rows)
            .permute(4, 1, 0, 2, 5, 3).contiguous())


def weight_matrix(wp: torch.Tensor, cout: int) -> torch.Tensor:
    """:func:`pack_weight`'s output -> the (Cout, 9 * Cin_p) int8 matrix,
    element [co, (u*3 + v) * Cin_p + ci] (zeros for ci >= Cin)."""
    pieces, chunks, _, _, rows, _ = wp.shape
    m = wp.permute(0, 4, 2, 1, 3, 5).reshape(pieces * rows, 9, chunks * CIN_CHUNK)
    return m[:cout].reshape(cout, -1)


# the kernel's tiling (csrc/conv3x3_int8.cu: n_for, m_tiles, consumers, ...)
_TW = 64                       # output columns per tile: one m64 wgmma tile a row
_HALO_W = _TW + 2
_N_MAX = 256                   # output channels per block
_MAX_STAGES = 4
_ALIGN = 128
_PIECE_MAX = 64
_SM_SMEM = 233_472             # shared memory of an SM; each block reserves 1 KiB more


@dataclass(frozen=True)
class Geometry:
    """One launch of ``csrc/conv3x3_int8.cu``, as the source computes it.

    ``route`` is "tma" (Cin, and Cin2 of a split input, multiples of 16) or
    "im2col" (1 <= Cin < 16, no split).  The tiles, ``n_tiles`` of them,
    run ``b``-major, then row block (``tile[0]`` rows), column block
    (``tile[1]`` = 64 columns) and Cout piece (``n`` channels at ``piece *
    256``); block ``i`` of the persistent ``grid`` takes tiles ``i, i +
    grid, ...``.  ``stages`` is the TMA ring's depth, ``smem_bytes`` the
    dynamic shared memory of a block."""

    route: str
    n: int
    tile: Tuple[int, int]
    n_pieces: int
    stages: int
    smem_bytes: int
    n_tiles: int
    grid: int
    blocks_per_sm: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _n_for(cout: int) -> int:
    return next(n for n in (16, 32, 64, 128, 256) if cout <= n or n == _N_MAX)


def _consumers(n: int) -> int:
    """Consumer warpgroups a block: one at N = 16 (three blocks an SM), else two."""
    return 1 if n <= 16 else 2


def _fixed_bytes(n: int) -> int:
    """Epilogue staging, mul / badd, the mbarriers and the alignment slack."""
    staging = _consumers(n) * _TW * (min(n, _PIECE_MAX) * 4 + 16)
    return staging + 8 * n + 16 * _MAX_STAGES + _ALIGN


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, h: int, w: int, cin: int, cout: int, cin2: int = 0,
                    sms: int = H100_SMS) -> Geometry:
    """The kernel's launch for x (b, h, w, cin) [+ x2 with cin2 channels] ->
    cout channels, on a card of ``sms`` SMs (``csrc/conv3x3_int8.cu``:
    ``geometry``; ``cin`` as the kernel gets it, after the wrapper's pad)."""
    n = _n_for(cout)
    rows = _consumers(n) * {256: 1, 128: 2, 64: 4}.get(n, 8)
    fixed = _fixed_bytes(n)
    if cin2 == 0 and cin < 16:
        route, stages, per_sm = "im2col", 1, 4 if n <= 16 else 1
        steps = -(-9 * cin // CIN_CHUNK)
        halo = _round_up((rows + 2) * _HALO_W * cin, 16)
        smem = (rows * _TW * CIN_CHUNK + steps * CIN_CHUNK * n + 4 * steps * CIN_CHUNK + halo
                + fixed)
    else:
        route, per_sm = "tma", 3 if n <= 16 else 1
        plane = _round_up((rows + 2) * _HALO_W * 16, _ALIGN)
        stage = 2 * plane + 18 * n * 16
        budget = min(SMEM_MAX, _SM_SMEM // per_sm - 1024)
        stages = min(_MAX_STAGES, (budget - fixed) // stage)
        smem = stages * stage + fixed
    n_pieces = -(-cout // _N_MAX)
    n_tiles = b * -(-h // rows) * -(-w // _TW) * n_pieces
    most = sms * per_sm // n_pieces * n_pieces
    grid = n_tiles if n_tiles < most else (most if most > 0 else n_pieces)
    return Geometry(route, n, (rows, _TW), n_pieces, stages, smem, n_tiles, grid, per_sm)


def _check(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
           out_dtype: torch.dtype, x2: Optional[torch.Tensor] = None, act: str = "relu",
           inv_s: Optional[torch.Tensor] = None) -> None:
    for name, t in (("x", x), ("x2", x2)):
        if t is not None and (t.dim() != 4 or t.dtype != torch.int8 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int8 (B, H, W, C) tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if x2 is not None and x2.shape[:3] != x.shape[:3]:
        raise ValueError(f"x {tuple(x.shape)} and x2 {tuple(x2.shape)} differ in (B, H, W)")
    cin = x.shape[3] + (0 if x2 is None else x2.shape[3])
    cout = mul.shape[0] if mul.dim() == 1 else 0
    for name, t in (("mul", mul), ("badd", badd)):
        if (cout < 1 or t.shape != (cout,) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 (Cout,) tensor, Cout >= 1, got "
                             f"{t.dtype} {tuple(t.shape)} (mul {tuple(mul.shape)})")
    rows = _rows_for(cout)
    want = (-(-cout // rows), _cin_padded(cin) // CIN_CHUNK, 9, 2, rows, 16)
    if wp.dtype != torch.int8 or not wp.is_contiguous() or tuple(wp.shape) != want:
        raise ValueError(f"w must be pack_weight's contiguous int8 {want} for Cin = {cin} and "
                         f"Cout = {cout}, got {wp.dtype} {tuple(wp.shape)}")
    if out_dtype not in _OUT_KIND:
        raise TypeError(f"out_dtype must be one of {tuple(_OUT_KIND)}, not {out_dtype}")
    if act not in _ACT:
        raise ValueError(f"act must be one of {tuple(_ACT)}, not {act!r}")
    if (act == "silu" and out_dtype == torch.int8) != (inv_s is not None):
        raise ValueError("inv_s is the SiLU requant's scale: give it exactly when act is "
                         "'silu' and out_dtype int8")
    if inv_s is not None and (inv_s.numel() != 1 or inv_s.dim() > 1
                              or inv_s.dtype != torch.float32):
        raise ValueError(f"inv_s must be a 0-dim or (1,) f32 tensor, got {inv_s.dtype} "
                         f"{tuple(inv_s.shape)}")
    devices = {x.device, wp.device, mul.device, badd.device}
    for t in (x2, inv_s):
        if t is not None:
            devices.add(t.device)
    if len(devices) != 1:
        raise ValueError("x, x2, w, mul, badd and inv_s must lie on one device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_int8 runs on cuda or cpu, not {x.device}")


def epilogue(acc: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
             out_dtype: torch.dtype, act: str = "relu",
             inv_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 sums -> the requant (int8) or dequant (f32/bf16) output: the
    multiply and the add as two f32 roundings, then ReLU and, for int8,
    round half to even and clip to [0, 127]; or SiLU (``silu_f32``'s ``z *
    torch.sigmoid(z)`` in f32) and, for int8, ``z * inv_s`` rounded half to
    even and clipped to [-127, 127] (JAX ``_requant_signed``)."""
    z = acc.float() * mul + badd
    if act == "silu":
        yf = z * torch.sigmoid(z)
        if out_dtype == torch.int8:
            return torch.clamp(torch.round(yf * inv_s.reshape(())), -127, 127).to(torch.int8)
        return yf.to(out_dtype)
    yf = torch.clamp_min(z, 0.0)
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(yf), 0, 127).to(torch.int8)
    return yf.to(out_dtype)


def conv3x3_int8_sums(x: torch.Tensor, wp: torch.Tensor, cout: int) -> torch.Tensor:
    """The plain int32 (B, H, W, cout) sums: the (B, H, W, 9*Cin) im2col
    patch times the packed weight in float64 (exact), cast to int32, over a
    few images at a time so that the patch's memory stays bounded."""
    b, h, w, cin = x.shape
    wmat = (weight_matrix(wp, cout).reshape(cout, 9, -1)[:, :, :cin]
            .reshape(cout, 9 * cin).double().T)
    acc = torch.empty((b, h, w, cout), dtype=torch.int32, device=x.device)
    step = max(1, _REFERENCE_ROWS // (h * w))
    for i in range(0, b, step):
        acc[i:i + step] = (_patches(x[i:i + step]).double() @ wmat).to(torch.int32)
    return acc


def conv3x3_int8_reference(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor,
                           badd: torch.Tensor, out_dtype: torch.dtype,
                           x2: Optional[torch.Tensor] = None, act: str = "relu",
                           inv_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: :func:`conv3x3_int8_sums` of x, or of the channel
    concatenation [x, x2] (exact in integers), then :func:`epilogue`."""
    _check(x, wp, mul, badd, out_dtype, x2, act, inv_s)
    xc = x if x2 is None else torch.cat([x, x2], dim=-1)
    return epilogue(conv3x3_int8_sums(xc, wp, mul.shape[0]), mul, badd, out_dtype, act, inv_s)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t.clone() if t.data_ptr() % 16 else t


_P, _I32 = ctypes.c_void_p, ctypes.c_int
_CSRC = KernelLibrary("conv3x3_int8", conv3x3_int8_nhwc=([_P] * 7 + [_I32] * 9 + [_P], _I32),
                      conv3x3_int8_geometry=([_I32] * 6 + [ctypes.POINTER(_I32)], _I32))


def _launch(x, wp, mul, badd, out_dtype, x2=None, act="relu", inv_s=None) -> torch.Tensor:
    """One launch of csrc/conv3x3_int8.cu on CUDA tensors (checked by the caller)."""
    b, h, w, cin = x.shape
    cin2 = 0 if x2 is None else x2.shape[3]
    cout = mul.shape[0]
    # TMA reads x (and x2) as 16-channel pieces from a 16-byte aligned base:
    # a split whose parts are not 16-multiples is concatenated, other Cin >=
    # 16 padded with zero channels (they meet the packed weight's zero rows);
    # Cin < 16 without x2 goes to the im2col kernel as it is, under ReLU (the
    # im2col kernel is built with ReLU only: a SiLU conv pads to 16).
    if cin2 and (cin % 16 or cin2 % 16):
        x, x2, cin, cin2 = torch.cat([x, x2], dim=-1), None, cin + cin2, 0
    if cin2 == 0 and (cin >= 16 or act == "silu"):
        pad = -cin % 16
        x, cin = (F.pad(x, (0, pad)), cin + pad) if pad else (_aligned(x), cin)
    if x2 is not None:
        x, x2 = _aligned(x), _aligned(x2)
    y = torch.empty((b, h, w, cout), dtype=out_dtype, device=x.device)
    _CSRC.launch("conv3x3_int8_nhwc", x, x.data_ptr(), None if x2 is None else x2.data_ptr(),
                 wp.data_ptr(), mul.data_ptr(), badd.data_ptr(),
                 None if inv_s is None else inv_s.data_ptr(), y.data_ptr(), b, h, w, cin, cin2,
                 cout, _OUT_KIND[out_dtype], _ACT[act])
    return y


def _fake(x, wp, mul, badd, out_dtype, x2=None, act="relu", inv_s=None):
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], mul.shape[0]), dtype=out_dtype)


_conv3x3_int8_op = register_op(
    'conv3x3_int8(Tensor x, Tensor wp, Tensor mul, Tensor badd, ScalarType out_dtype, '
    'Tensor? x2, str act="relu", Tensor? inv_s=None) -> Tensor',
    _launch, cpu=conv3x3_int8_reference, fake=_fake)


def conv3x3_int8(x: torch.Tensor, wp: torch.Tensor, mul: torch.Tensor, badd: torch.Tensor,
                 out_dtype: torch.dtype = torch.int8,
                 x2: Optional[torch.Tensor] = None, act: str = "relu",
                 inv_s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: contiguous int8 (B, H, W, Cin), and optionally x2 (B, H, W, Cin2),
    the second part of a split input; wp: :func:`pack_weight` of the int8
    HWIO weight over Cin + Cin2 channels; mul, badd: f32 (Cout,) -> (B, H,
    W, Cout) in ``out_dtype``: int8 requantised, or f32 / bf16 dequantised,
    through ``act``, "relu" or "silu"; ``inv_s`` (a 0-dim or (1,) f32
    tensor, the output's 1 / scale) for a SiLU requant only (see the module
    docstring).

    A CUDA tensor launches ``csrc/conv3x3_int8.cu`` (counted as
    ``LAUNCHES["conv3x3_int8"]``); a CPU tensor runs the plain version."""
    _check(x, wp, mul, badd, out_dtype, x2, act, inv_s)
    return _conv3x3_int8_op(x, wp, mul, badd, out_dtype, x2, act, inv_s)


def kernel_geometry(b: int, h: int, w: int, cin: int, cout: int, cin2: int = 0) -> Geometry:
    """The geometry the built kernel takes on the current CUDA device (its
    own ``conv3x3_int8_geometry``), for holding :func:`launch_geometry`
    against it."""
    out = (ctypes.c_int * 9)()
    _CSRC.check(_CSRC.entry("conv3x3_int8_geometry")(b, h, w, cin, cin2, cout, out),
                "conv3x3_int8_geometry")
    route, n, rows, n_pieces, stages, smem, n_tiles, grid, per_sm = out
    return Geometry(("tma", "im2col")[route], n, (rows, _TW), n_pieces, stages, smem, n_tiles,
                    grid, per_sm)
