"""YOLOv8-style segmentation network as ``nn.Module``s over NHWC activations.

The JAX package's ``models/yolov8_seg.py`` (its ``_apply_nhwc``): a CSP
backbone of C2f blocks and SPPF, a top-down FPN neck, and a proto-style mask
head back to input resolution, returning dense logits (B, H, W, n_classes)
f32.  ``yolov8_seg_s`` has widths 32..512, C2f depths (1, 2, 2, 1) and one
class (binary) by default; H and W must be multiples of ``hw_divisor`` = 32.

Blocks, as JAX's:

* CBS: a kxk conv without bias (stride 1 or 2, pad k // 2) -> BN -> SiLU,
  the SiLU computed in f32 and cast back to the conv's dtype;
* Bottleneck: two 3x3 CBS and the residual ``x + y``;
* C2f: a 1x1 CBS, its output split at ``c = cout // 2`` into two halves, a
  chain of n Bottlenecks on the second half, the ``2 + n`` parts
  concatenated and fused by a 1x1 CBS;
* SPPF: a 1x1 CBS to half the channels, three 5x5 stride-1 max pools
  (padding counts as -inf), the four concatenated, a 1x1 CBS.

The model: a stride-2 stem CBS, four (stride-2 CBS, C2f) stages, SPPF; the
neck upsamples x2 by nearest neighbour and concatenates ``[up, skip]``
before each C2f (P5 -> P4 -> P3); the head runs three (ConvTranspose k2 s2,
3x3 CBS) steps from stride 8 to stride 1 and a 1x1 conv with bias.

Every conv goes through ``ops/nn.py:conv2d``, so the dispatch rule sends the
3x3 stride-1 convs with 8 <= Cin <= 32 to the hand kernel (C2f0's
bottleneck, ``p_c2`` and ``p_c3`` at the S widths); the stride-2 and 1x1
convs, the pools and the ConvTranspose ups stay on ``torch.nn.functional``,
as the JAX main path leaves them to XLA.  Submodules are named after the
JAX pytree's keys (``stem``, ``down{i}``, ``c2f{i}/m{k}/cv{1,2}``, ``sppf``,
``n4``, ``n3``, ``p_up{k}``, ``p_c{k}``, ``head``), each CBS holding
``conv`` and ``bn``.

``forward(x, group, shard)``, as the UNet's: with a ``shard`` (spatial
parallelism, ``ops/halo.py``) x is one band of rows of the images.  Every
3x3 conv takes a 1-row halo (``ops/nn.py:conv2d``: the stride-1 rule, or
the stride-2 one for the stem and ``down{i}``), and each of SPPF's three
pools a 2-row halo of -inf (:func:`maxpool5_same`); the x2 upsamples, the
concatenations, the ConvT ups, the 1x1 convs and the head are row-local.
A band must hold a multiple of ``hw_divisor`` rows (``unet.check_band``),
and at least 2 rows at stride 32, so that a pool's halo comes from the
neighbouring band alone: H >= spatial_shards * 64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.halo import halo_exchange
from ..ops.nn import conv2d, conv_transpose2d
from .blocks import OutConv, _bn_apply, _conv_hwio
from .unet import check_band

__all__ = ["CBS", "Bottleneck", "C2f", "SPPF", "YOLOv8Seg", "yolov8_seg_s", "silu_f32",
           "maxpool5_same", "upsample_nearest2"]


def silu_f32(y: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) in f32, cast back to y's dtype (JAX's rounding)."""
    yf = y.float()
    return (yf * torch.sigmoid(yf)).to(y.dtype)


def maxpool5_same(x: torch.Tensor, shard=None) -> torch.Tensor:
    """5x5 stride-1 SAME max pool of NHWC x (padding counts as -inf); on a
    ``shard``'s band, that pool of the whole images: 2 rows of each
    neighbour, -inf beyond the image (a zero row would win the max over
    SiLU outputs, which go down to -0.278)."""
    pad = 2
    if shard is not None:
        x, pad = halo_exchange(x, shard, 2, fill=float("-inf")), (0, 2)
    return F.max_pool2d(x.permute(0, 3, 1, 2), 5, stride=1, padding=pad).permute(0, 2, 3, 1)


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest-neighbour upsample of NHWC x: each pixel repeated 2x2."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class CBS(nn.Module):
    """Conv (no bias, stride 1 or 2, pad k // 2) -> BN -> SiLU."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        k = self.conv.kernel_size[0]
        y = conv2d(x, _conv_hwio(self.conv), stride=self.stride, padding=k // 2,
                   compute_dtype=compute_dtype, shard=shard)
        return silu_f32(_bn_apply(self.bn, y, self.training, group))


class Bottleneck(nn.Module):
    """Two 3x3 CBS and the residual shortcut."""

    def __init__(self, c: int):
        super().__init__()
        self.cv1, self.cv2 = CBS(c, c, 3), CBS(c, c, 3)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        y = self.cv1(x, compute_dtype, group, shard)
        return x + self.cv2(y, compute_dtype, group, shard)


class C2f(nn.Module):
    """1x1 CBS, split in halves, n Bottlenecks on the second, concat, 1x1 CBS."""

    def __init__(self, cin: int, cout: int, n: int):
        super().__init__()
        c = cout // 2
        self.n = n
        self.cv1 = CBS(cin, cout, 1)
        self.cv2 = CBS((2 + n) * c, cout, 1)
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        y = self.cv1(x, compute_dtype, group)
        c = y.shape[-1] // 2
        parts = [y[..., :c], y[..., c:]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1], compute_dtype, group, shard))
        return self.cv2(torch.cat(parts, dim=-1), compute_dtype, group)


class SPPF(nn.Module):
    """1x1 CBS to c // 2, three chained 5x5 max pools, concat of the four, 1x1 CBS."""

    def __init__(self, c: int):
        super().__init__()
        self.cv1, self.cv2 = CBS(c, c // 2, 1), CBS(c * 2, c, 1)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None, shard=None):
        y = self.cv1(x, compute_dtype, group)
        # each pool exchanges its own input: one 6-row exchange would need
        # p1's and p2's rows beyond the image set back to -inf between pools
        p1 = maxpool5_same(y, shard)
        p2 = maxpool5_same(p1, shard)
        p3 = maxpool5_same(p2, shard)
        return self.cv2(torch.cat([y, p1, p2, p3], dim=-1), compute_dtype, group)


class YOLOv8Seg(nn.Module):
    """CSP backbone + FPN neck + proto mask head -> dense segmentation logits.

    ``bilinear`` is accepted for the UNet family's constructor contract and
    unused, as in JAX.  ``remat`` is accepted and unused too: the JAX
    model's YOLO forward never reads its ``remat`` field."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, bilinear: bool = False,
                 widths: Tuple[int, int, int, int, int] = (32, 64, 128, 256, 512),
                 depths: Tuple[int, int, int, int] = (1, 2, 2, 1), remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, name: str = "yolov8_seg_s"):
        super().__init__()
        self.n_channels, self.n_classes, self.bilinear = n_channels, n_classes, bilinear
        self.widths, self.depths = tuple(widths), tuple(depths)
        self.compute_dtype, self.name, self.remat = compute_dtype, name, remat
        w, d = self.widths, self.depths
        self.stem = CBS(n_channels, w[0], 3, stride=2)
        for i in range(4):
            self.add_module(f"down{i}", CBS(w[i], w[i + 1], 3, stride=2))
            self.add_module(f"c2f{i}", C2f(w[i + 1], w[i + 1], d[i]))
        self.sppf = SPPF(w[4])
        self.n4 = C2f(w[4] + w[3], w[3], d[2])
        self.n3 = C2f(w[3] + w[2], w[2], d[1])
        c = w[2]
        self.p_up1 = nn.ConvTranspose2d(c, c // 2, kernel_size=2, stride=2)
        self.p_c1 = CBS(c // 2, c // 2, 3)
        self.p_up2 = nn.ConvTranspose2d(c // 2, c // 4, kernel_size=2, stride=2)
        self.p_c2 = CBS(c // 4, c // 4, 3)
        self.p_up3 = nn.ConvTranspose2d(c // 4, c // 4, kernel_size=2, stride=2)
        self.p_c3 = CBS(c // 4, c // 4, 3)
        self.head = OutConv(c // 4, n_classes)

    @property
    def hw_divisor(self) -> int:
        """The H and W divisibility the stride-32 backbone needs."""
        return 32

    def _up(self, name: str, t: torch.Tensor) -> torch.Tensor:
        up = getattr(self, name)
        return conv_transpose2d(t, up.weight.permute(2, 3, 0, 1), up.bias, stride=2,
                                compute_dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor, group=None, shard=None) -> torch.Tensor:
        """x: (B, H, W, n_channels) or (B, H, W) -> logits (B, H, W, n_classes) f32;
        a train forward's BN statistics reduce over ``group`` (None: one
        device); with a ``shard``, x and the logits are one band of rows
        (see the module docstring)."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        check_band(x.shape[1], shard, self.hw_divisor)
        if shard is not None and x.shape[1] < 2 * self.hw_divisor:
            raise ValueError(
                f"spatial sharding of {self.name} needs bands of at least 2 rows at stride 32 "
                f"(SPPF's 5x5 pools read 2 rows of each neighbour): H must be at least "
                f"spatial_shards * 64 = {shard.size * 2 * self.hw_divisor}; H "
                f"{x.shape[1] * shard.size} is not")
        cd, g, s = self.compute_dtype, group, shard
        y = self.stem(x, cd, g, s)                                    # /2
        feats = []
        for i in range(4):
            y = getattr(self, f"down{i}")(y, cd, g, s)                # /4 /8 /16 /32
            y = getattr(self, f"c2f{i}")(y, cd, g, s)
            feats.append(y)
        y = self.sppf(y, cd, g, s)                                    # P5 /32
        p4 = self.n4(torch.cat([upsample_nearest2(y), feats[2]], dim=-1), cd, g, s)   # /16
        p3 = self.n3(torch.cat([upsample_nearest2(p4), feats[1]], dim=-1), cd, g, s)  # /8
        t = self.p_c1(self._up("p_up1", p3), cd, g, s)                # /4
        t = self.p_c2(self._up("p_up2", t), cd, g, s)                 # /2
        t = self.p_c3(self._up("p_up3", t), cd, g, s)                 # /1
        return self.head(t, cd).float()


def yolov8_seg_s(n_channels=1, n_classes=1, **kw) -> YOLOv8Seg:
    """The S width scale (32..512), binary by default."""
    return YOLOv8Seg(n_channels=n_channels, n_classes=n_classes, **kw)
