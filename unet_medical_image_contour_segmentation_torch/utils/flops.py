"""Logical forward FLOP counts, the port's counterpart of the JAX package's
``utils/flops.py``.

"Logical" = the operations of the math the model defines (2 * H * W * k * k
* cin * cout per conv), however a kernel executes it.
:func:`unet_forward_flops` is the JAX package's closed form for the UNet
family, copied (it is pure Python); :func:`forward_flops` counts any model
of the port (UNet++ and YOLOv8-seg too) with ``torch.utils.flop_counter``,
where the JAX package reads XLA's HLO cost analysis.  No device peak is
kept here: a utilisation states the card and its power limit beside it.

The backward pass is about 2x the forward (one dgrad and one wgrad pass
per conv), so a train step is about 3x the forward.
"""

from __future__ import annotations

import copy

import torch

__all__ = ["unet_forward_flops", "forward_flops"]


def _conv(h, w, k, cin, cout):
    return 2 * h * w * k * k * cin * cout


def _taps(n: int, k: int, stride: int = 1, pad: int = 0, dilation: int = 1) -> int:
    """(output position, tap) pairs of a 1-D window whose input index lies
    inside the n input positions: the products a padded conv really does."""
    n_out = (n + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    return sum(1 for o in range(n_out) for t in range(k)
               if 0 <= o * stride - pad + t * dilation < n)


def _conv_flop(x_shape, w_shape, _bias, stride, padding, dilation, transposed, *args,
               out_shape=None, **kwargs) -> int:
    """aten.convolution on NCHW: 2 * Cin * Cout per product of an input
    pixel and a tap, the zero padding left out (a transpose conv meets every
    tap of every input pixel)."""
    b, cin = x_shape[0], x_shape[1]
    if transposed:
        pairs = 1
        for n, k in zip(x_shape[2:], w_shape[2:]):
            pairs *= n * k
        return 2 * b * cin * w_shape[1] * pairs
    pairs = 1
    for n, k, s, p, d in zip(x_shape[2:], w_shape[2:], stride, padding, dilation):
        pairs *= _taps(n, k, s, p, d)
    return 2 * b * w_shape[0] * w_shape[1] * pairs


def _conv3x3_flop(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    """The hand 3x3 SAME conv (``umics::conv3x3_nhwc``, NHWC x HWIO)."""
    b, h, w, cin = x_shape
    return 2 * b * cin * w_shape[3] * _taps(h, 3, pad=1) * _taps(w, 3, pad=1)


def forward_flops(model: torch.nn.Module, h: int, w: int) -> int:
    """Forward operations of one (h, w) slice through ``model``, counted by
    ``FlopCounterMode`` over an f32 eval forward of a CPU copy at batch 1:
    its convolutions (the hand 3x3 kernel's operator included), transpose
    convolutions and matrix products, each product with a zero-padding tap
    left out, as XLA's cost analysis counts them (the JAX package's
    ``hlo_forward_flops``); elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import conv3x3  # noqa: F401  (registers umics::conv3x3_nhwc)

    net = copy.deepcopy(model).float().cpu().eval()
    net.compute_dtype = None
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution: _conv_flop,
        torch.ops.umics.conv3x3_nhwc: _conv3x3_flop,
    })
    with torch.no_grad(), counter:
        net(torch.zeros(1, h, w, net.n_channels))
    return counter.get_total_flops()


def unet_forward_flops(model, h: int, w: int) -> int:
    """Logical forward FLOPs for one slice of shape (h, w) through a UNet.

    Mirrors the channel plan of ``UNet.init`` (models/unet.py): widths
    ``W0..W4``, ``factor=2`` halving the bottleneck/decoder widths when
    bilinear, ConvTranspose(k2, s2) upsampling otherwise, optional k7
    spatial-attention conv on every skip.  Elementwise work (BN, ReLU,
    pooling, bilinear upsample taps) is omitted — it is <1% of the conv
    FLOPs at these shapes.
    """
    W = model.widths
    f = 2 if model.bilinear else 1
    total = 0

    # inc at full resolution: cin -> W0 -> W0
    total += _conv(h, w, 3, model.n_channels, W[0]) + _conv(h, w, 3, W[0], W[0])

    # encoder: down_i runs at h/2^i
    down_io = [(W[0], W[1]), (W[1], W[2]), (W[2], W[3]), (W[3], W[4] // f)]
    for i, (cin, cout) in enumerate(down_io, 1):
        hh, ww = h >> i, w >> i
        total += _conv(hh, ww, 3, cin, cout) + _conv(hh, ww, 3, cout, cout)

    # decoder: up_i produces resolution h/2^(4-i)
    up_io = [
        (W[4], W[3] // f),
        (W[3], W[2] // f),
        (W[2], W[1] // f),
        (W[1], W[0]),
    ]
    for i, (cin, cout) in enumerate(up_io, 1):
        hh, ww = h >> (4 - i), w >> (4 - i)
        if model.bilinear:
            # upsample is tap arithmetic (omitted); DoubleConv(cin, cout, mid=cin//2)
            mid = cin // 2
        else:
            # ConvTranspose2d(k=2, s=2): every output pixel touches exactly one
            # kernel tap -> 2 * Hout * Wout * cin * cout/... == 2*hh*ww*cin*(cin//2)
            total += 2 * hh * ww * cin * (cin // 2)
            mid = cout
        if model.use_attention:
            total += _conv(hh, ww, 7, 2, 1)
        total += _conv(hh, ww, 3, cin, mid) + _conv(hh, ww, 3, mid, cout)

    # 1x1 head at full resolution
    total += _conv(h, w, 1, W[0], model.n_classes)
    return total
