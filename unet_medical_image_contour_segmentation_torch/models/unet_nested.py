"""UNet++ (nested UNet) as one width-parameterised ``nn.Module``.

The JAX package's ``models/unet_nested.py`` (its ``_apply_nhwc``), with the
presets ``unet_pp_s`` (widths 16..256) and ``unet_pp`` (64..1024).  Node
X[i][j] sits at depth i (spatial /2^i) and nest index j:

    X[i][0] = DoubleConv over the input (i = 0) or the 2x2 max pool of X[i-1][0]
    X[i][j] = DoubleConv(concat(X[i][0..j-1], up(X[i+1][j-1])))

``up`` is a ConvTranspose (k2, s2, w[i+1] -> w[i]) or, with ``bilinear``, a
x2 bilinear upsample with ``align_corners=True`` that keeps w[i+1]
channels; it is zero-padded to the skips' size before the concat.  The
logits are the 1x1 head ``outc`` on X[0][depth-1], or with
``deep_supervision`` the mean of the heads ``out{j}`` on X[0][1..depth-1].
Input is NHWC (B, H, W, C), or (B, H, W) read as C = 1; logits come back
f32 NHWC.  H and W must be multiples of ``hw_divisor`` = 2^(depth-1).

Every 3x3 conv goes through ``ops/nn.py:conv2d`` (the routed ones to the
hand kernel), as the UNet's do.  ``remat=True`` rematerialises each node's
DoubleConv in a train forward that records gradients, as JAX's
``ckpt(B.double_conv_apply)``; BN statistics move once (see
``models/unet.py``).  With a ``shard`` the forward computes one band of
rows of the images, as the UNet's does (``models/unet.py``).  The JAX
package's ``wide`` and ``s2d`` layouts are TPU tiling workarounds of the
same function and are not ported.

The submodules are named after the JAX pytree's keys (``x{i}_{j}``,
``up{i}_{j}``, ``outc`` / ``out{j}``), which is how
``models/torch_compat.py`` carries the weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.nn import conv_transpose2d, max_pool2d
from ..ops.resize import upsample_x2_align_corners
from .blocks import DoubleConv, OutConv, _pad_to_match
from .unet import _direct, _rematerialised, check_band

__all__ = ["UNetPlusPlus", "unet_pp", "unet_pp_s"]


class UNetPlusPlus(nn.Module):
    """Nested UNet of ``len(widths)`` depths (see the module docstring)."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, bilinear: bool = False,
                 widths: Tuple[int, ...] = (16, 32, 64, 128, 256),
                 deep_supervision: bool = False, remat: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, name: str = "unet_pp_s"):
        super().__init__()
        self.n_channels, self.n_classes, self.bilinear = n_channels, n_classes, bilinear
        self.widths, self.deep_supervision = tuple(widths), deep_supervision
        self.compute_dtype, self.name, self.remat = compute_dtype, name, remat
        w, d = self.widths, self.depth
        for i in range(d):
            self.add_module(f"x{i}_0", DoubleConv(n_channels if i == 0 else w[i - 1], w[i]))
        for j in range(1, d):
            for i in range(d - j):
                if not bilinear:
                    self.add_module(f"up{i}_{j}",
                                    nn.ConvTranspose2d(w[i + 1], w[i], kernel_size=2, stride=2))
                cin_up = w[i + 1] if bilinear else w[i]
                self.add_module(f"x{i}_{j}", DoubleConv(w[i] * j + cin_up, w[i]))
        if deep_supervision:
            for j in range(1, d):
                self.add_module(f"out{j}", OutConv(w[0], n_classes))
        else:
            self.outc = OutConv(w[0], n_classes)

    @property
    def depth(self) -> int:
        return len(self.widths)

    @property
    def hw_divisor(self) -> int:
        """The H and W divisibility the pooling chain needs."""
        return 2 ** (self.depth - 1)

    def _up(self, i: int, j: int, feat: torch.Tensor, shard=None) -> torch.Tensor:
        if self.bilinear:
            return upsample_x2_align_corners(feat, shard)
        up = getattr(self, f"up{i}_{j}")
        # (in, out, kh, kw) -> HWIO with I = in
        return conv_transpose2d(feat, up.weight.permute(2, 3, 0, 1), up.bias, stride=2,
                                compute_dtype=self.compute_dtype)

    def forward(self, x: torch.Tensor, group=None, shard=None) -> torch.Tensor:
        """x: (B, H, W, n_channels) or (B, H, W) -> logits (B, H, W, n_classes) f32;
        a train forward's BN statistics reduce over ``group`` (None: one device);
        with a ``shard``, x and the logits are one band of rows."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        check_band(x.shape[1], shard, self.hw_divisor)
        cd, d = self.compute_dtype, self.depth
        run = _rematerialised if self.remat and self.training and torch.is_grad_enabled() \
            else _direct
        nodes = {}
        for i in range(d):
            inp = x if i == 0 else max_pool2d(nodes[(i - 1, 0)], 2)
            nodes[(i, 0)] = run(getattr(self, f"x{i}_0"), inp, cd, group, shard)
        for j in range(1, d):
            for i in range(d - j):
                skips = [nodes[(i, k)] for k in range(j)]
                upped = _pad_to_match(self._up(i, j, nodes[(i + 1, j - 1)], shard), skips[0])
                feats = torch.cat(skips + [upped.to(skips[0].dtype)], dim=-1)
                nodes[(i, j)] = run(getattr(self, f"x{i}_{j}"), feats, cd, group, shard)
        if self.deep_supervision:
            outs = [getattr(self, f"out{j}")(nodes[(0, j)], cd) for j in range(1, d)]
            logits = sum(outs) / len(outs)
        else:
            logits = self.outc(nodes[(0, d - 1)], cd)
        return logits.float()


def unet_pp_s(n_channels=1, n_classes=1, bilinear=False, **kw) -> UNetPlusPlus:
    """UNet++ with the UNet_S widths, 16..256."""
    return UNetPlusPlus(n_channels, n_classes, bilinear, widths=(16, 32, 64, 128, 256),
                        name="unet_pp_s", **kw)


def unet_pp(n_channels=1, n_classes=1, bilinear=False, **kw) -> UNetPlusPlus:
    """UNet++ with the standard UNet's widths, 64..1024."""
    return UNetPlusPlus(n_channels, n_classes, bilinear, widths=(64, 128, 256, 512, 1024),
                        name="unet_pp", **kw)
