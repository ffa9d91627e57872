"""3x3 stride-1 SAME convolution, NHWC, as hand-written Hopper kernels, with
its gradients.

Replaces the TPU kernel ``ops/pallas_conv.py:conv_s2d_b4_im2col`` of the JAX
package (``pallas_call`` at :133) and its custom VJP (``_bwd_rule``,
:178-190).  That kernel takes a space-to-depth-4 tensor only to get around
the TPU's (8, 128) memory tiling at C < 128; a Hopper kernel reads NHWC with
C = 8..64 directly, so the kernels here compute the same function, a 3x3
SAME conv with f32 accumulation and one rounding, on NHWC tensors, and
:func:`conv_s2d_b4_im2col` keeps the TPU kernel's s2d contract as a thin
``s2d . conv . d2s`` wrapper.

Gradients, as the JAX package takes them: dx is the same kernel on the
output gradient with the weight rotated 180 degrees and in/out swapped
(:func:`conv3x3_nhwc_dx`); dw, which JAX leaves to an XLA linear transpose
outside the Pallas kernel, is cuDNN's weight gradient on the card and the
transposed im2col product on the CPU (:func:`conv3x3_nhwc_dw`).

Bound: bytes.  The function reads x and writes y once; at the unet_s shapes
that takes about three times as long at 3.35 TB/s as its 2*9*Cin*Cout
operations per pixel take on the tensor cores, and a fifth as long as they
take on the CUDA cores.  So a CUDA tensor goes by dtype to one of two hand
kernels in ``csrc/conv3x3.cu`` (:func:`route`), in plain sight:

- bf16 -> ``"tensor_core"``: an implicit GEMM on ``mma.sync`` bf16 with f32
  sums.  A block owns an 8x32 pixel tile and up to 64 output channels (all
  of Cout <= 64), stages the halo tile and the weight in shared memory with
  16-byte ``cp.async``, feeds the tensor cores with ``ldmatrix`` and stores
  16-byte chunks (:func:`launch_geometry`, :func:`conv3x3_nhwc_tiled_reference`).
- f32 -> ``"cuda_core"``: f32 FMAs, because the tensor cores would round f32
  inputs to TF32 and the f32 callers (the card-vs-CPU checks, the f32
  reference predictor) need full f32 products.

Each wrapper runs a kernel for a CUDA tensor and its plain version for a CPU
tensor; nothing else picks between them, and nothing falls back.

The forward is the operator ``umics::conv3x3_nhwc``, declared through the
kernels' one seam (``_build.py``): its CUDA implementation is the launch,
counted as ``LAUNCHES["conv3x3_nhwc"]`` and under its route
(``"conv3x3_nhwc.tensor_core"``), its CPU implementation the plain
version, and its fake implementation gives the output's shape and dtype
from the inputs', with H and W left symbolic.  ``torch.export`` traces
through the op without touching a pointer, and an exported program
(``engine/export.py``) calls the same launch when it runs; a program loads
only once this module has registered the op.  dx takes the same launch
path, counted as ``"conv3x3_nhwc_dx"``.  Training takes the op inside the
autograd Function below.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.s2d import d2s, s2d
from . import _build
from ._build import KernelLibrary, register_launch, register_op

__all__ = [
    "Geometry",
    "conv3x3_nhwc",
    "conv3x3_nhwc_dx",
    "conv3x3_nhwc_dw",
    "conv3x3_nhwc_reference",
    "conv3x3_nhwc_tiled_reference",
    "conv3x3_nhwc_dw_reference",
    "conv_s2d_b4_im2col",
    "kernel_blocks_per_sm",
    "kernel_smem_bytes",
    "launch_geometry",
    "pack_weight",
    "rotate_weight",
    "route",
    "supported",
]

CIN_MIN, CIN_MAX = 8, 64          # what the kernels take (dx: Cin = the forward's Cout)
DISPATCH_CIN_MAX = 32             # the forward rule of the JAX package
SMEM_MAX = 232_448                # dynamic shared memory a block may use on sm_90
_GRID_MAX = 65535                 # gridDim.y and gridDim.z
_DTYPES = (torch.bfloat16, torch.float32)
_ROUTES = {torch.bfloat16: "tensor_core", torch.float32: "cuda_core"}


def supported(w_shape, stride: int = 1, padding: int = 0) -> bool:
    """The dispatch rule: a 3x3, stride-1, pad-1 conv with 8 <= Cin <= 32
    (the JAX rule of ``ops/s2d.py:179-181``, minus its layout and env terms)."""
    kh, kw, cin, _ = w_shape
    return (kh, kw, stride, padding) == (3, 3, 1, 1) and CIN_MIN <= cin <= DISPATCH_CIN_MAX


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA tensor of ``dtype`` launches: ``"tensor_core"`` for
    bf16, ``"cuda_core"`` for f32."""
    if dtype not in _ROUTES:
        raise TypeError(f"conv3x3_nhwc takes one of {_DTYPES}, not {dtype}")
    return _ROUTES[dtype]


@dataclass(frozen=True)
class Geometry:
    """One launch of a kernel of ``csrc/conv3x3.cu``, as the source computes it.

    Block ``(bx, by, bz)`` covers image ``bz // n_chunks``, output rows
    ``by * tile[0]`` on and columns ``bx * tile[1]`` on (``tile`` of each,
    cut at the image edge), and output channels ``(bz % n_chunks) *
    cout_chunk`` on (``cout_chunk`` of them, cut at Cout).  ``cin_padded``
    is the channel count the block stages per halo pixel (zeros past Cin).
    """

    route: str
    grid: Tuple[int, int, int]
    tile: Tuple[int, int]
    cout_chunk: int
    n_chunks: int
    cin_padded: int
    smem_bytes: int


def _odd_row_bytes(elems: int) -> int:
    """A row of ``elems`` bf16 in shared memory: its 16-byte chunks, one more
    if their count is even (the ``ldmatrix`` rows then miss each other's banks)."""
    return 16 * ((elems // 8) | 1)


@functools.lru_cache(maxsize=1024)
def launch_geometry(b: int, h: int, w: int, cin: int, cout: int,
                    dtype: torch.dtype) -> Geometry:
    """The grid, tiles, Cout chunks and shared memory of the kernel that a
    CUDA tensor of ``dtype`` launches (``csrc/conv3x3.cu``: ``mma_smem_bytes``,
    ``launch_mma`` for bf16; ``smem_bytes``, ``launch_f32`` for f32)."""
    kind = route(dtype)
    if kind == "tensor_core":
        tile = (8, 32)
        cout_chunk = 8 * next(n for n in (1, 2, 4, 8) if 8 * n >= min(cout, 64))
        cin_p = -(-cin // 16) * 16
        row = _odd_row_bytes(cout_chunk)
        halo_px = (tile[0] + 2) * (tile[1] + 2)
        staged = halo_px * _odd_row_bytes(cin_p) + 9 * cin_p * row
        smem = max(staged, tile[0] * tile[1] * row)
    else:
        tile, cout_chunk, cin_p = (16, 32), 16, cin
        words = (cin * 4 + 3) // 4 | 1          # halo pixel stride, odd in words
        smem = 9 * cin * cout_chunk * 4 + (tile[0] + 2) * (tile[1] + 2) * words * 4
    n_chunks = -(-cout // cout_chunk)
    grid = (-(-w // tile[1]), -(-h // tile[0]), b * n_chunks)
    return Geometry(kind, grid, tile, cout_chunk, n_chunks, cin_p, smem)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, Cin, Cout) -> the kernels' row-major (9*Cin, Cout) matrix,
    row (u*3 + v)*Cin + ci.  A view when ``w`` is contiguous, so a weight
    stored contiguous in the compute dtype is packed once, where it is stored."""
    return w.reshape(9 * w.shape[2], w.shape[3]).contiguous()


def rotate_weight(w: torch.Tensor) -> torch.Tensor:
    """The weight of the input gradient: HWIO rotated 180 degrees with in and
    out swapped, ``w[::-1, ::-1].transpose(0, 1, 3, 2)`` (pallas_conv.py:182)."""
    return w.flip(0, 1).transpose(2, 3)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"want x (B, H, W, Cin) and w (3, 3, Cin, Cout); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    cin, cout = w.shape[2], w.shape[3]
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, w expects {cin}")
    if not CIN_MIN <= cin <= CIN_MAX or cout < 1:
        raise ValueError(f"conv3x3_nhwc takes {CIN_MIN} <= Cin <= {CIN_MAX} and "
                         f"Cout >= 1; got Cin={cin}, Cout={cout}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype of {_DTYPES}; "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC")


def _patches(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> the (B, H, W, 9*C) zero-padded 3x3 neighbourhoods,
    channel (u*3 + v)*C + c: the rows of :func:`pack_weight`."""
    _, h, wd, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, u:u + h, v:v + wd, :] for u in range(3) for v in range(3)],
                     dim=-1)


def conv3x3_nhwc_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: pad by 1, concatenate the 9 shifted slices into a
    (B, H, W, 9*Cin) patch, one product with the packed weight in f32, cast."""
    _check(x, w)
    y = _patches(x).float() @ pack_weight(w).float()
    return y.to(x.dtype)


def conv3x3_nhwc_tiled_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch, through its
    :func:`launch_geometry`: x zero-padded to ``cin_padded`` channels, the
    packed weight cut into (9, ``cin_padded``, ``cout_chunk``) blocks with zero
    rows past Cin and zero columns past Cout, and per chunk the sum over the
    9 taps of the shifted x times that tap's block, in f32, rounded once."""
    _check(x, w)
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    geo = launch_geometry(b, h, wd, cin, cout, torch.bfloat16)
    n, cin_p = geo.cout_chunk, geo.cin_padded
    xp = F.pad(x.float(), (0, cin_p - cin, 1, 1, 1, 1))
    wp = F.pad(pack_weight(w).float().reshape(9, cin, cout),
               (0, geo.n_chunks * n - cout, 0, cin_p - cin))
    y = torch.zeros((b, h, wd, geo.n_chunks * n), dtype=torch.float32, device=x.device)
    for c in range(geo.n_chunks):
        for t in range(9):
            u, v = divmod(t, 3)
            y[..., c * n:(c + 1) * n] += xp[:, u:u + h, v:v + wd, :] @ wp[t, :, c * n:(c + 1) * n]
    return y[..., :cout].to(x.dtype)


_P, _I32 = ctypes.c_void_p, ctypes.c_int
_LAUNCH = ([_P, _P, _P] + [_I32] * 6 + [_P], _I32)
_CSRC = KernelLibrary("conv3x3", conv3x3_nhwc_bf16=_LAUNCH, conv3x3_nhwc_f32=_LAUNCH,
                      conv3x3_smem_bytes=([_I32] * 3, ctypes.c_longlong),
                      conv3x3_blocks_per_sm=([_I32] * 3, _I32))
_ENTRY = {"tensor_core": "conv3x3_nhwc_bf16", "cuda_core": "conv3x3_nhwc_f32"}


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/conv3x3.cu on CUDA tensors (checked by the caller)."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    geo = launch_geometry(b, h, wd, cin, cout, x.dtype)
    if max(geo.grid[1:]) > _GRID_MAX:
        raise ValueError(f"shape {tuple(x.shape)} -> {cout} exceeds the launch grid {geo.grid}")
    wp = pack_weight(w)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    _CSRC.launch(_ENTRY[geo.route], x, x.data_ptr(), wp.data_ptr(), y.data_ptr(), b, h, wd, cin,
                 cout)
    return y


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    return route(x.dtype)


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3_nhwc runs on cuda or cpu, not {x.device}")
    return x.device.type


def _fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], w.shape[3]))


_forward = register_op("conv3x3_nhwc(Tensor x, Tensor w) -> Tensor", _launch,
                       cpu=conv3x3_nhwc_reference, fake=_fake, route=_route)
register_launch("conv3x3_nhwc_dx", _launch, route=_route)


def conv3x3_nhwc_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of ``y = conv3x3_nhwc(x, w)`` for the output gradient ``g``: the same
    conv of ``g`` with :func:`rotate_weight` of ``w``, in ``w``'s dtype.

    A CUDA tensor goes to the kernel of its :func:`route` (counted as
    ``LAUNCHES["conv3x3_nhwc_dx"]``), a CPU tensor to the plain version.
    """
    g = g.to(w.dtype).contiguous()
    w_rot = rotate_weight(w)
    _check(g, w_rot)
    if _device_of(g) == "cpu":
        return conv3x3_nhwc_reference(g, w_rot)
    return _build.launch("conv3x3_nhwc_dx", g, w_rot)


def conv3x3_nhwc_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain dw: the im2col patch of x transposed times g, in f32, cast
    to x's dtype; HWIO (3, 3, Cin, Cout)."""
    cin, cout = x.shape[3], g.shape[3]
    dw = _patches(x).float().reshape(-1, 9 * cin).T @ g.float().reshape(-1, cout)
    return dw.reshape(3, 3, cin, cout).to(x.dtype)


def conv3x3_nhwc_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of ``y = conv3x3_nhwc(x, w)`` for the output gradient ``g``, HWIO in
    x's dtype.  JAX computes it outside the Pallas kernel (an XLA linear
    transpose, pallas_conv.py:185-189); on the card it is cuDNN's weight
    gradient on the channels_last views, on the CPU the plain version."""
    g = g.to(x.dtype)
    if _device_of(x) == "cpu":
        return conv3x3_nhwc_dw_reference(x, g)
    cin, cout = x.shape[3], g.shape[3]
    # read for its shape and layout only (output_mask leaves dx out)
    w_shape = torch.empty((cout, cin, 3, 3), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
    _, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w_shape, None,
        [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, False])
    return dw.permute(2, 3, 1, 0)


class _Conv3x3(torch.autograd.Function):
    """The kernel with the JAX package's custom VJP (pallas_conv.py:174-190)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()  # g may arrive as a permuted view
        dx = conv3x3_nhwc_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_nhwc_dw(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y[b,h,w,co] = sum_{u,v,ci} x[b,h+u-1,w+v-1,ci] * w[u,v,ci,co], zero padded.

    x: contiguous (B, H, W, Cin), bf16 or f32; w: HWIO (3, 3, Cin, Cout) in
    x's dtype -> (B, H, W, Cout) in x's dtype, summed in f32.  A CUDA tensor
    goes to the kernel of its :func:`route` (counted as
    ``LAUNCHES["conv3x3_nhwc"]``), a CPU tensor to the plain version (both
    through the operator ``umics::conv3x3_nhwc``).  When x or w requires grad the call is
    differentiable: dx through :func:`conv3x3_nhwc_dx` (the kernel again,
    so Cout must lie in 8..64) and dw through :func:`conv3x3_nhwc_dw`.
    """
    _check(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x.requires_grad and not CIN_MIN <= w.shape[3] <= CIN_MAX:
            raise ValueError(f"the input gradient runs the kernel with Cin = Cout, so "
                             f"{CIN_MIN} <= Cout <= {CIN_MAX}; got Cout={w.shape[3]}")
        return _Conv3x3.apply(x, w)
    return _forward(x, w)


def kernel_smem_bytes(cin: int, cout: int, dtype: torch.dtype) -> int:
    """The built kernel's own count of a block's dynamic shared memory (needs
    nvcc and the library; :func:`launch_geometry` is its pure-Python mirror)."""
    return _CSRC.entry("conv3x3_smem_bytes")(cin, cout, int(route(dtype) == "tensor_core"))


def kernel_blocks_per_sm(cin: int, cout: int, dtype: torch.dtype) -> int:
    """Blocks of the kernel resident on one SM at that shape (the CUDA
    occupancy calculator; needs the card)."""
    n = _CSRC.entry("conv3x3_blocks_per_sm")(cin, cout, int(route(dtype) == "tensor_core"))
    if n < 0:
        _CSRC.check(-n, "cudaOccupancyMaxActiveBlocksPerMultiprocessor")
    return n


def conv_s2d_b4_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's contract: (B, Gh, Gw, 16*Cin) s2d-4 x, HWIO w ->
    (B, Gh, Gw, 16*Cout), computed as ``s2d(conv3x3_nhwc(d2s(x, 4), w), 4)``."""
    return s2d(conv3x3_nhwc(d2s(x, 4).contiguous(), w), 4)
