"""Bilinear resize with PyTorch's index rules, NHWC, as two matrix products.

The same construction as the JAX package's ``ops/resize.py``: separable
interpolation by a (out, in) row-stochastic matrix per axis, in f32.  Two
modes are used: ``align_corners=True`` for the x2 decoder upsample of the
bilinear UNet, and ``align_corners=False`` for the Predictor's back-resize of
the logits to the original image size.

Under ``torch.export`` with symbolic H and W (the exported programs of
``engine/export.py``) the matrices are built from the runtime sizes with
torch ops in the same float64 arithmetic, so an exported bilinear UNet
takes any H and W and computes what the eager one does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .halo import halo_exchange

__all__ = ["bilinear_resize", "upsample_x2_align_corners"]


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, with the source
    index of ATen's ``area_pixel_compute_source_index``."""
    if in_size == out_size:
        return np.eye(out_size, dtype=np.float32)
    dst = np.arange(out_size, dtype=np.float64)
    if align_corners:
        src = np.zeros_like(dst) if out_size == 1 else dst * (in_size - 1) / (out_size - 1)
    else:
        src = np.maximum(in_size / out_size * (dst + 0.5) - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    frac = (src - i0).astype(np.float32)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    rows = np.arange(out_size)
    # np.add.at accumulates both weights where i0 == i1 (the edge pixel)
    np.add.at(mat, (rows, i0), 1.0 - frac)
    np.add.at(mat, (rows, i1), frac)
    return mat


def _interp_matrix_symbolic(in_size, out_size, align_corners: bool,
                            device) -> torch.Tensor:
    """:func:`_interp_matrix_np` for symbolic sizes, in torch ops."""
    dst = torch.arange(out_size, dtype=torch.float64, device=device)
    if align_corners:
        src = dst * (in_size - 1) / (out_size - 1)
    else:
        src = torch.clamp_min(in_size / out_size * (dst + 0.5) - 0.5, 0.0)
    i0 = torch.clamp(torch.floor(src).long(), 0, in_size - 1)
    i1 = torch.clamp_max(i0 + 1, in_size - 1)
    frac = (src - i0).float()
    cols = torch.arange(in_size, device=device)
    return ((cols == i0[:, None]) * (1.0 - frac)[:, None]
            + (cols == i1[:, None]) * frac[:, None])


@functools.lru_cache(maxsize=None)
def _interp_matrix_on_card(in_size: int, out_size: int, align_corners: bool,
                           device: torch.device) -> torch.Tensor:
    """:func:`_interp_matrix_np` copied to a CUDA device once.  A copy from
    host memory waits for the device's stream, so a copy each call would
    stall the host mid-forward; made outside inference mode, so that a
    training forward may save it for its backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(_interp_matrix_np(in_size, out_size, align_corners)).to(device)


def _interp_matrix(in_size, out_size, align_corners: bool, device) -> torch.Tensor:
    if isinstance(in_size, torch.SymInt) or isinstance(out_size, torch.SymInt):
        return _interp_matrix_symbolic(in_size, out_size, align_corners, device)
    device = torch.device(device)
    if (device.type == "cuda" and not torch.compiler.is_compiling()
            and torch._guards.detect_fake_mode() is None):
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return _interp_matrix_on_card(in_size, out_size, align_corners, device)
    return torch.from_numpy(_interp_matrix_np(in_size, out_size, align_corners)).to(device)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int, *,
                    align_corners: bool) -> torch.Tensor:
    """Resize NHWC ``x`` to (out_h, out_w); computed in f32, cast back.

    ``align_corners=True`` matches ``nn.Upsample(..., align_corners=True)``,
    ``False`` matches ``F.interpolate(..., mode='bilinear')``.
    """
    _, h, w, _ = x.shape
    if (h, w) == (out_h, out_w):
        return x
    mh = _interp_matrix(h, out_h, align_corners, x.device)
    mw = _interp_matrix(w, out_w, align_corners, x.device)
    y = torch.einsum("oh,nhwc->nowc", mh, x.float())
    y = torch.einsum("pw,nowc->nopc", mw, y)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _band_matrix_np(h: int, index: int, size: int) -> np.ndarray:
    """(2h, h + 2): the rows of the whole images' x2 align-corners matrix
    (``size`` bands of ``h`` rows) that band ``index``'s output rows take,
    over its input rows with one halo row above and below.  Every output
    row of the band reads input rows ``index * h - 1 .. (index + 1) * h``:
    its source coordinate ``o * (H - 1) / (2H - 1)`` lies within half a row
    below ``o / 2``."""
    full = _interp_matrix_np(h * size, 2 * h * size, True)[2 * h * index:2 * h * (index + 1)]
    return np.pad(full, ((0, 0), (1, 1)))[:, h * index:h * index + h + 2]


def upsample_x2_align_corners(x: torch.Tensor, shard=None) -> torch.Tensor:
    """x2 bilinear upsample with align_corners=True; on a ``shard``'s band of
    rows (``ops/halo.py``), the band's rows of the whole images' upsample,
    from the band and one halo row of each neighbour."""
    _, h, w, _ = x.shape
    if shard is None:
        return bilinear_resize(x, 2 * h, 2 * w, align_corners=True)
    mh = torch.from_numpy(_band_matrix_np(h, shard.index, shard.size)).to(x.device)
    mw = _interp_matrix(w, 2 * w, True, x.device)
    y = torch.einsum("oh,nhwc->nowc", mh, halo_exchange(x, shard, 1).float())
    y = torch.einsum("pw,nowc->nopc", mw, y)
    return y.to(x.dtype)
