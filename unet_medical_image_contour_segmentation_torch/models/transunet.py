"""TransUNet, the R50-ViT-B/16 hybrid (arXiv:2102.04306), over NHWC activations.

The published network (github.com/Beckschen/TransUNet,
``networks/vit_seg_modeling.py`` and ``vit_seg_modeling_resnet_skip.py``)
written out in the port's conventions: input NHWC (B, H, W, C), or (B, H, W)
read as C = 1, logits f32 NHWC, every conv and linear in ``compute_dtype``.

* A 1-channel input is repeated to the 3 channels of the ResNet's root, as
  the published forward does.  Every ResNet conv is a StdConv2d: its weight
  standardised over (Cin, kh, kw) before the conv (``ops/vit.py``).
* Root: 7x7 stride-2 conv, GroupNorm, ReLU (skip f0), then a 3x3 stride-2
  max pool without padding.  Three blocks of pre-activation bottlenecks
  (``units``; stride 2 on the 3x3 conv of blocks 2 and 3); block 1's output
  is zero-padded at the bottom and right to a quarter of the image (skip
  f1; 127 -> 128 at 512²) and block 2's is skip f2.
* A 1x1 conv with bias embeds block 3's map as tokens, plus the position
  embeddings and dropout; ``layers`` pre-norm blocks of multi-head
  attention and a GELU MLP, then a final LayerNorm.  The residual stream
  and the norms run in f32.
* The cascaded upsampler (CUP): the tokens as a map, a Conv2dReLU (3x3 conv
  without bias, BN, ReLU), then per decoder block a x2 bilinear upsample
  with ``align_corners=True``, the concat ``[up, skip]`` and two
  Conv2dReLU; a 3x3 head conv with bias.

The position embeddings are stored for ``img_size`` (a grid of
``img_size / 16`` tokens a side).  An image of another size, H and W
multiples of 16, gets them resampled to its grid as the published
``load_from`` resamples pretrained ones (``ndimage.zoom`` of order 1:
bilinear, the corner samples kept); at ``img_size`` they are added as
stored.  Parameter names are the published
modules' (``transformer.embeddings.hybrid_model.root.conv.weight``,
``decoder.conv_more.0.weight``, ``segmentation_head.0.weight``, ...) in
their OIHW layout, so a TransUNet state_dict loads with ``strict=True``.

``forward(x, group)``: the decoder's BN statistics of a train forward
reduce over the process group (None: one device); GroupNorm and LayerNorm
are per image.  Row sharding (``shard``) is not supported.  The serving
fold is ``models/fold_bn.py:fold_transunet``.  The forward's three stages
are the spans ``transunet.resnet``, ``transunet.transformer`` and
``transunet.decoder``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.nn import conv2d
from ..ops.resize import upsample_x2_align_corners
from ..ops.vit import attention, group_norm, layer_norm, standardize_weight
from ..utils.profiling import span
from .blocks import _bn_apply

__all__ = ["TransUNet", "transunet_r50_b16", "transunet_tiny", "StdConv2d", "Conv2dReLU"]

GN_EPS = 1e-6
LN_EPS = 1e-6


class StdConv2d(nn.Conv2d):
    """A weight holder whose conv standardises its weight first; the serving
    fold stores the standardised weight and sets ``standardized``."""

    standardized = False

    def apply_nhwc(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        w = self.weight if self.standardized else standardize_weight(self.weight)
        return conv2d(x, w.permute(2, 3, 1, 0), stride=self.stride[0], padding=self.padding[0],
                      compute_dtype=compute_dtype)


def _gn(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    return group_norm(x, norm.num_groups, norm.weight, norm.bias, norm.eps)


class PreActBottleneck(nn.Module):
    """The published bottleneck unit: 1x1, 3x3 (stride ``stride``), 1x1 convs,
    each followed by GroupNorm (ReLU after the first two), a projected
    residual (1x1 conv of stride ``stride`` and GroupNorm) where the shape
    changes, and a ReLU of the sum."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int, groups: int):
        super().__init__()
        self.gn1 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn2 = nn.GroupNorm(groups, cmid, eps=GN_EPS)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1, bias=False)
        self.gn3 = nn.GroupNorm(groups, cout, eps=GN_EPS)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride, bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None):
        r = x
        if hasattr(self, "downsample"):
            r = _gn(self.gn_proj, self.downsample.apply_nhwc(x, compute_dtype))
        y = torch.relu(_gn(self.gn1, self.conv1.apply_nhwc(x, compute_dtype)))
        y = torch.relu(_gn(self.gn2, self.conv2.apply_nhwc(y, compute_dtype)))
        y = _gn(self.gn3, self.conv3.apply_nhwc(y, compute_dtype))
        return torch.relu(r + y)


class ResNetV2(nn.Module):
    """Root and body of the hybrid's ResNet (``root.{conv,gn}``,
    ``body.block{i}.unit{j}``)."""

    def __init__(self, units: Sequence[int], width: int, groups: int):
        super().__init__()
        self.root = nn.Sequential(OrderedDict(
            conv=StdConv2d(3, width, 7, stride=2, padding=3, bias=False),
            gn=nn.GroupNorm(groups, width, eps=GN_EPS), relu=nn.ReLU()))
        blocks = []
        cin = width
        for i, n in enumerate(units):
            cout, cmid = width * 4 * 2 ** i, width * 2 ** i
            stride = 1 if i == 0 else 2
            blocks.append((f"block{i + 1}", nn.Sequential(OrderedDict(
                (f"unit{j + 1}", PreActBottleneck(cin if j == 0 else cout, cout, cmid,
                                                  stride if j == 0 else 1, groups))
                for j in range(n)))))
            cin = cout
        self.body = nn.Sequential(OrderedDict(blocks))


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key = nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)
        self.value, self.out = nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (_linear(lin, x, compute_dtype).view(b, n, self.heads, d // self.heads)
                   .transpose(1, 2) for lin in (self.query, self.key, self.value))
        y = attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        return _linear(self.out, y, compute_dtype)


class Mlp(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(hidden, mlp_dim), nn.Linear(mlp_dim, hidden)


class Block(nn.Module):
    """A pre-norm transformer block (``attention_norm``, ``attn``,
    ``ffn_norm``, ``ffn``)."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn_norm = nn.LayerNorm(hidden, eps=LN_EPS)
        self.ffn = Mlp(hidden, mlp_dim)
        self.attn = Attention(hidden, heads)


class Embeddings(nn.Module):
    def __init__(self, units, width: int, groups: int, hidden: int, tokens: int):
        super().__init__()
        self.hybrid_model = ResNetV2(units, width, groups)
        self.patch_embeddings = nn.Conv2d(width * 4 * 2 ** (len(units) - 1), hidden, 1)
        self.position_embeddings = nn.Parameter(torch.zeros(1, tokens, hidden))


class Encoder(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp_dim: int, layers: int):
        super().__init__()
        self.layer = nn.ModuleList(Block(hidden, heads, mlp_dim) for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=LN_EPS)


class Transformer(nn.Module):
    def __init__(self, embeddings: Embeddings, encoder: Encoder):
        super().__init__()
        self.embeddings, self.encoder = embeddings, encoder


class Conv2dReLU(nn.Sequential):
    """3x3 conv without bias, BN, ReLU (``{0, 1, 2}``); the serving fold makes
    it conv + bias with the ReLU in one pass (``fold_bn.FoldedConv2dReLU``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
                         nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor, compute_dtype: Optional[torch.dtype] = None,
                group=None) -> torch.Tensor:
        y = conv2d(x, self[0].weight.permute(2, 3, 1, 0), padding=1, compute_dtype=compute_dtype)
        return torch.relu(_bn_apply(self[1], y, self.training, group))


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = Conv2dReLU(cin + skip, cout)
        self.conv2 = Conv2dReLU(cout, cout)


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, head_channels: int, channels: Sequence[int],
                 skips: Sequence[int]):
        super().__init__()
        self.conv_more = Conv2dReLU(hidden, head_channels)
        ins = [head_channels, *channels[:-1]]
        self.blocks = nn.ModuleList(DecoderBlock(i, o, s) for i, o, s in zip(ins, channels, skips))


def _linear(lin: nn.Linear, x: torch.Tensor, compute_dtype: Optional[torch.dtype]):
    if compute_dtype is None:
        return F.linear(x, lin.weight, lin.bias)
    return F.linear(x.to(compute_dtype), lin.weight.to(compute_dtype),
                    lin.bias.to(compute_dtype))


class TransUNet(nn.Module):
    """TransUNet with a ResNet-ViT hybrid encoder (see the module docstring).
    ``bilinear`` must be True (the decoder upsamples bilinearly); ``remat``
    must be False."""

    def __init__(self, n_channels: int = 1, n_classes: int = 3, bilinear: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, *, img_size: int = 512,
                 units: Tuple[int, ...] = (3, 4, 9), width: int = 64, hidden: int = 768,
                 heads: int = 12, layers: int = 12, mlp_dim: int = 3072,
                 head_channels: int = 512, decoder_channels: Tuple[int, ...] = (256, 128, 64, 16),
                 n_skip: int = 3, groups: int = 32, dropout: float = 0.1,
                 name: str = "transunet_r50_b16", remat: bool = False):
        super().__init__()
        if not bilinear:
            raise ValueError("TransUNet's decoder upsamples bilinearly: bilinear must be True")
        if remat:
            raise NotImplementedError("TransUNet has no rematerialised forward")
        if n_channels not in (1, 3):
            raise ValueError(f"TransUNet takes 1 or 3 input channels, not {n_channels}")
        self.n_channels, self.n_classes, self.bilinear = n_channels, n_classes, True
        self.compute_dtype, self.name, self.remat = compute_dtype, name, False
        self.img_size, self.heads, self.dropout = img_size, heads, dropout
        outs = [width * 4 * 2 ** i for i in range(len(units))]
        self.widths = (width, *outs, hidden)
        self.grid = img_size // 16
        # the skips' channels, deepest first: block 2's, block 1's, the root's
        skips = [*outs[-2::-1], width, 0][:len(decoder_channels)]
        self.skip_channels = [c if i < n_skip else 0 for i, c in enumerate(skips)]
        self.n_skip = n_skip
        self.transformer = Transformer(
            Embeddings(units, width, groups, hidden, self.grid ** 2),
            Encoder(hidden, heads, mlp_dim, layers))
        self.decoder = DecoderCup(hidden, head_channels, decoder_channels, self.skip_channels)
        self.segmentation_head = nn.Sequential(
            nn.Conv2d(decoder_channels[-1], n_classes, 3, padding=1), nn.Identity())

    @property
    def hw_divisor(self) -> int:
        return 16

    def forward(self, x: torch.Tensor, group=None, shard=None) -> torch.Tensor:
        """x: (B, H, W, n_channels) or (B, H, W), H and W multiples of 16 ->
        logits (B, H, W, n_classes) f32."""
        if shard is not None:
            raise NotImplementedError("TransUNet has no row-sharded forward")
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        if x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(f"{self.name} takes H and W multiples of 16 (its patch grid), "
                             f"not {tuple(x.shape[1:3])}")
        cd = self.compute_dtype
        with span("transunet.resnet"):
            y, skips = self._resnet(x, cd)
        with span("transunet.transformer"):
            tokens = self._transformer(y, cd)
        with span("transunet.decoder"):
            y = self._decoder(tokens, y.shape[1:3], skips, cd, group)
        return y.float()

    def _resnet(self, x: torch.Tensor, cd) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """-> block 3's map and the skips, deepest first."""
        hybrid = self.transformer.embeddings.hybrid_model
        root = hybrid.root
        if x.shape[-1] != root.conv.weight.shape[1]:
            x = x.repeat(1, 1, 1, root.conv.weight.shape[1] // x.shape[-1])
        y = torch.relu(_gn(root.gn, root.conv.apply_nhwc(x, cd)))
        skips = [y]
        y = F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        blocks = list(hybrid.body)
        for i, block in enumerate(blocks):
            for unit in block:
                y = unit(y, cd)
            if i < len(blocks) - 1:
                dh = x.shape[1] // 4 // (i + 1) - y.shape[1]
                dw = x.shape[2] // 4 // (i + 1) - y.shape[2]
                skips.append(F.pad(y, (0, 0, 0, dw, 0, dh)) if dh or dw else y)
        return y, skips[::-1]

    def _transformer(self, y: torch.Tensor, cd) -> torch.Tensor:
        """Block 3's map -> the final LayerNorm's (B, N, hidden) f32 tokens."""
        emb = self.transformer.embeddings
        patch = emb.patch_embeddings
        y = conv2d(y, patch.weight.permute(2, 3, 1, 0), patch.bias, compute_dtype=cd)
        t = y.reshape(y.shape[0], -1, y.shape[-1]).float() + self._position_embeddings(
            *y.shape[1:3])
        t = F.dropout(t, self.dropout, self.training)
        enc = self.transformer.encoder
        for blk in enc.layer:
            a = layer_norm(t, blk.attention_norm.weight, blk.attention_norm.bias, LN_EPS)
            t = t + blk.attn(a, cd)
            m = layer_norm(t, blk.ffn_norm.weight, blk.ffn_norm.bias, LN_EPS)
            m = F.dropout(F.gelu(_linear(blk.ffn.fc1, m, cd)), self.dropout, self.training)
            t = t + F.dropout(_linear(blk.ffn.fc2, m, cd), self.dropout, self.training)
        return layer_norm(t, enc.encoder_norm.weight, enc.encoder_norm.bias, LN_EPS)

    def _position_embeddings(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh * gw, hidden): as stored on the preset's grid, else resampled."""
        pe = self.transformer.embeddings.position_embeddings
        if (gh, gw) == (self.grid, self.grid):
            return pe
        g = pe.view(1, self.grid, self.grid, -1).permute(0, 3, 1, 2)
        g = F.interpolate(g, size=(gh, gw), mode="bilinear", align_corners=True)
        return g.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)

    def _decoder(self, tokens: torch.Tensor, grid: Tuple[int, int], skips: List[torch.Tensor],
                 cd, group) -> torch.Tensor:
        b, n, d = tokens.shape
        x = self.decoder.conv_more(tokens.view(b, *grid, d), cd, group)
        for i, blk in enumerate(self.decoder.blocks):
            x = upsample_x2_align_corners(x)
            if i < self.n_skip:
                x = torch.cat([x, skips[i].to(x.dtype)], dim=-1)
            x = blk.conv2(blk.conv1(x, cd, group), cd, group)
        head = self.segmentation_head[0]
        return conv2d(x, head.weight.permute(2, 3, 1, 0), head.bias, padding=1, compute_dtype=cd)


def transunet_r50_b16(n_channels=1, n_classes=3, bilinear=True, **kw) -> TransUNet:
    """The published R50-ViT-B/16 hybrid at 512²: ResNet units (3, 4, 9) of
    width 64, 12 layers of 768 with 12 heads and an MLP of 3072, decoder
    (256, 128, 64, 16) with 3 skips, dropout 0.1."""
    return TransUNet(n_channels, n_classes, bilinear, name="transunet_r50_b16", **kw)


def transunet_tiny(n_channels=1, n_classes=3, bilinear=True, **kw) -> TransUNet:
    """A tiny TransUNet for tests on the CPU: 64², units (1, 1, 1) of width 8,
    GroupNorm of 4 groups, 2 layers of 32 with 2 heads, MLP 64, decoder
    (16, 16, 8, 8)."""
    kw = dict(dict(img_size=64, units=(1, 1, 1), width=8, hidden=32, heads=2, layers=2,
                   mlp_dim=64, head_channels=32, decoder_channels=(16, 16, 8, 8), groups=4), **kw)
    return TransUNet(n_channels, n_classes, bilinear, name="transunet_tiny", **kw)
