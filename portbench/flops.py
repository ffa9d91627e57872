"""The benchmark's frozen arithmetic: logical FLOPs, a 3x3 conv's roofline
count and the card's published peaks.

:func:`unet_forward_flops` is a copy of the closed form of the port's
``utils/flops.py:unet_forward_flops`` (2 * H * W * k * k * Cin * Cout per
conv; ConvTranspose k2 s2 meets one tap per output pixel; elementwise work
left out), for the ConvTranspose UNet without attention, taking a
configuration file's fields instead of a model.  It is
frozen here so that a later change to the program cannot move the
yardstick; a test holds the two equal at 512².  A train step is counted as
3x the forward (forward, dgrad, wgrad), the convention that file states.

:func:`conv3x3_bound_s` is the least time one 3x3 stride-1 SAME conv can take
on the card: the larger of its operations (2 * 9 * Cin * Cout per output
pixel) at the bf16 peak and its bytes (input, weight and output, each once,
in their dtype) at the HBM bandwidth.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["PEAK_FLOPS", "PEAK_BYTES_PER_S", "ITEMSIZE", "TRAIN_FLOPS_PER_FORWARD",
           "unet_forward_flops", "conv3x3_ops", "conv3x3_bytes", "conv3x3_bound_s"]

# NVIDIA H100 SXM data sheet, dense: bf16 / fp16 tensor cores, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
TRAIN_FLOPS_PER_FORWARD = 3


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> int:
    return 2 * h * w * k * k * cin * cout


def unet_forward_flops(cfg: dict, h: int, w: int) -> int:
    """Logical forward FLOPs of one (h, w) slice through the UNet of a
    configuration file (``widths``, ``n_channels``, ``n_classes``; ConvTranspose
    ups, no attention)."""
    if cfg.get("bilinear") or cfg.get("attention"):
        raise ValueError("this count covers the ConvTranspose UNet without attention")
    W = cfg["widths"]
    total = _conv(h, w, 3, cfg["n_channels"], W[0]) + _conv(h, w, 3, W[0], W[0])
    for i, (cin, cout) in enumerate(zip(W[:4], W[1:]), 1):
        hh, ww = h >> i, w >> i
        total += _conv(hh, ww, 3, cin, cout) + _conv(hh, ww, 3, cout, cout)
    for i, (cin, cout) in enumerate(zip(W[:0:-1], W[-2::-1]), 1):
        hh, ww = h >> (4 - i), w >> (4 - i)
        total += 2 * hh * ww * cin * (cin // 2)  # ConvTranspose k2 s2: one tap an output
        total += _conv(hh, ww, 3, cin, cout) + _conv(hh, ww, 3, cout, cout)
    total += _conv(h, w, 1, W[0], cfg["n_classes"])
    return total


def conv3x3_ops(n: int, h: int, w: int, cin: int, cout: int) -> int:
    """Operations of a 3x3 SAME conv over (n, h, w, cin) -> cout."""
    return 2 * 9 * cin * cout * n * h * w


def conv3x3_bytes(n: int, h: int, w: int, cin: int, cout: int,
                  itemsizes: Sequence[int]) -> int:
    """Bytes of input, weight and output, each once, at ``itemsizes`` =
    (input, weight, output) bytes an element."""
    xb, wb, yb = itemsizes
    return n * h * w * cin * xb + 9 * cin * cout * wb + n * h * w * cout * yb


def conv3x3_bound_s(n: int, h: int, w: int, cin: int, cout: int, itemsizes: Sequence[int],
                    dtype: str = "bfloat16") -> float:
    """The roofline bound of one such conv, in seconds."""
    return max(conv3x3_ops(n, h, w, cin, cout) / PEAK_FLOPS[dtype],
               conv3x3_bytes(n, h, w, cin, cout, itemsizes) / PEAK_BYTES_PER_S)
