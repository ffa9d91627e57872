"""The benchmark's frozen count of TransUNet's logical FLOPs.

Every conv (2 * H * W * k * k * Cin * Cout at its output size) and every
matmul (2 * M * N * K) of the published forward, the ResNet's root counted
on its 3 input channels as published; attention's two products over N
tokens are 2 * 2 * N² * hidden; norms, activations, the upsamples and the
pad are left out.  The sizes come from the configuration's preset
(``reference/transunet.py:PRESETS``).  At 512² the R50-ViT-B/16 slice is
336.3 GFLOP: transformer 212.6 (attention's products 38.7), decoder 81.2,
ResNet 41.0, patch embedding 1.6 (a test holds the parts).
"""

from __future__ import annotations

from typing import Dict

from portbench.reference.transunet import preset

__all__ = ["forward_flops_parts", "forward_flops", "attention_bound_s"]


def _conv(h: int, w: int, k: int, cin: int, cout: int) -> int:
    return 2 * h * w * k * k * cin * cout


def forward_flops_parts(cfg: dict) -> Dict[str, int]:
    """Logical forward FLOPs of one slice at the preset's image size, by part:
    ``resnet``, ``patch_embedding``, ``transformer`` (of which
    ``attention_products``) and ``decoder`` (with the head)."""
    p = preset(cfg)
    size, width = p["img_size"], p["width"]
    s = size // 2
    resnet = _conv(s, s, 7, 3, width)
    s = (s - 3) // 2 + 1  # max pool 3x3 stride 2, no padding
    cin = width
    for i, n in enumerate(p["units"]):
        cout, cmid = width * 4 * 2 ** i, width * 2 ** i
        for j in range(n):
            stride = 2 if i > 0 and j == 0 else 1
            out = (s - 1) // stride + 1
            resnet += _conv(s, s, 1, cin, cmid) + _conv(out, out, 3, cmid, cmid)
            resnet += _conv(out, out, 1, cmid, cout)
            if j == 0 and (stride != 1 or cin != cout):
                resnet += _conv(out, out, 1, cin, cout)
            s, cin = out, cout
    g = size // 16
    n, d, m = g * g, p["hidden"], p["mlp_dim"]
    patch = _conv(g, g, 1, cin, d)
    products = 2 * 2 * n * n * d
    transformer = p["layers"] * (4 * 2 * n * d * d + 2 * 2 * n * d * m + products)
    decoder = _conv(g, g, 3, d, p["head_channels"])
    ins = [p["head_channels"], *p["decoder_channels"][:-1]]
    for cin, cout, skip in zip(ins, p["decoder_channels"], p["skips"]):
        g *= 2
        decoder += _conv(g, g, 3, cin + skip, cout) + _conv(g, g, 3, cout, cout)
    decoder += _conv(g, g, 3, p["decoder_channels"][-1], cfg["n_classes"])
    return {"resnet": resnet, "patch_embedding": patch, "transformer": transformer,
            "attention_products": p["layers"] * products, "decoder": decoder}


def forward_flops(cfg: dict) -> int:
    """Logical forward FLOPs of one slice (the sum of the parts)."""
    parts = forward_flops_parts(cfg)
    return parts["resnet"] + parts["patch_embedding"] + parts["transformer"] + parts["decoder"]


def attention_bound_s(b: int, heads: int, n: int, d: int, peak_flops: float,
                      bytes_per_s: float, itemsize: int = 2) -> float:
    """The least time of one attention call over (b, heads, n, d): the larger
    of its two products (4 * b * heads * n² * d) at the peak and the bytes
    of q, k, v and the output, each once, at the bandwidth."""
    return max(4 * b * heads * n * n * d / peak_flops,
               4 * b * heads * n * d * itemsize / bytes_per_s)
