"""The UNet family as one width-parameterised ``nn.Module``.

The JAX package's ``models/unet.py`` with its presets ``unet`` (64..1024),
``unet_t`` (8..128), ``unet_s`` (16..256, the default) and ``unet_sa``
(unet_s widths with spatial attention on every Up); ``bilinear=True`` swaps
the ConvTranspose ups for x2 bilinear upsamples and halves the widths that
feed them, as the JAX ``UNet.init`` does.  Input is NHWC
(B, H, W, C), or (B, H, W) read as C = 1; logits come back f32 NHWC.
``compute_dtype`` (e.g. ``torch.bfloat16``) is the dtype every conv runs in.

``remat=True`` rematerialises each of the nine blocks (inc, down1-4, up1-4;
not the 1x1 head) in a train forward that records gradients, as the JAX
``UNet(remat=True)`` wraps them in ``jax.checkpoint``: a block keeps only its
inputs, and its forward runs again in the backward pass
(``torch.utils.checkpoint``, non-reentrant).  JAX returns the BN running
statistics functionally, so its remat step updates them once; here they
move in place in the forward, so the recompute runs with every BN of the
block marked ``recomputing`` and leaves them alone (``blocks._bn_apply``).
A remat step therefore equals a plain one, statistics included, and
launches the 3x3 kernel's forward twice for each conv it routes there.

``forward(x, group, shard)``: a train forward's BN statistics reduce over
the process group (cross-replica BN for data parallelism; None: one
device); with a ``shard`` (spatial parallelism, ``ops/halo.py``) x is one
band of rows of the images, every 3x3 conv (and unet_sa's 7x7 gate) takes
a halo of its neighbours' rows, and the logits are the band's rows of the
whole images' logits.  Every band must hold a multiple of ``hw_divisor``
rows, so that each pool sees whole windows (:func:`check_band`).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .blocks import DoubleConv, Down, OutConv, Up

__all__ = ["UNet", "unet", "unet_t", "unet_s", "unet_sa", "MODEL_REGISTRY", "get_model",
           "check_band"]


def check_band(h: int, shard, hw_divisor: int) -> None:
    """Raise unless a band of ``h`` rows of ``shard``'s images is a multiple of
    ``hw_divisor``: the images' H must be divisible by spatial_shards *
    hw_divisor, or a pool would drop rows inside the images."""
    if shard is not None and h % hw_divisor:
        raise ValueError(f"spatial sharding needs H divisible by spatial_shards * hw_divisor = "
                         f"{shard.size} * {hw_divisor}; H {h * shard.size} is not")


class UNet(nn.Module):
    """4-down / 4-up UNet, optionally with bilinear ups and spatial attention."""

    def __init__(self, n_channels: int = 1, n_classes: int = 3, bilinear: bool = False,
                 widths: Tuple[int, int, int, int, int] = (16, 32, 64, 128, 256),
                 use_attention: bool = False, compute_dtype: Optional[torch.dtype] = None,
                 name: str = "unet_s", remat: bool = False):
        super().__init__()
        self.n_channels, self.n_classes, self.bilinear = n_channels, n_classes, bilinear
        self.widths, self.use_attention = tuple(widths), use_attention
        self.compute_dtype, self.name, self.remat = compute_dtype, name, remat
        w, f = self.widths, 2 if bilinear else 1
        self.inc = DoubleConv(n_channels, w[0])
        self.down1, self.down2 = Down(w[0], w[1]), Down(w[1], w[2])
        self.down3, self.down4 = Down(w[2], w[3]), Down(w[3], w[4] // f)
        up = [(w[4], w[3] // f), (w[3], w[2] // f), (w[2], w[1] // f), (w[1], w[0])]
        self.up1, self.up2, self.up3, self.up4 = (Up(cin, cout, bilinear, use_attention)
                                                  for cin, cout in up)
        self.outc = OutConv(w[0], n_classes)

    @property
    def hw_divisor(self) -> int:
        """The H and W divisibility the four 2x2 pools need."""
        return 16

    def forward(self, x: torch.Tensor, group=None, shard=None) -> torch.Tensor:
        """x: (B, H, W, n_channels) or (B, H, W) -> logits (B, H, W, n_classes) f32."""
        if x.dim() == 3:
            x = x.unsqueeze(-1)
        check_band(x.shape[1], shard, self.hw_divisor)
        cd = self.compute_dtype
        run = _rematerialised if self.remat and self.training and torch.is_grad_enabled() \
            else _direct
        x1 = run(self.inc, x, cd, group, shard)
        x2 = run(self.down1, x1, cd, group, shard)
        x3 = run(self.down2, x2, cd, group, shard)
        x4 = run(self.down3, x3, cd, group, shard)
        x5 = run(self.down4, x4, cd, group, shard)
        y = run(self.up1, x5, x4, cd, group, shard)
        y = run(self.up2, y, x3, cd, group, shard)
        y = run(self.up3, y, x2, cd, group, shard)
        y = run(self.up4, y, x1, cd, group, shard)
        return self.outc(y, cd).float()


def _direct(block: nn.Module, *args):
    return block(*args)


@contextlib.contextmanager
def _recomputing(block: nn.Module) -> Iterator[None]:
    """Mark every BN of ``block`` as recomputing for the duration (the
    backward may run on another thread, so the mark sits on the modules)."""
    bns = [m for m in block.modules() if isinstance(m, nn.BatchNorm2d)]
    for bn in bns:
        bn.recomputing = True
    try:
        yield
    finally:
        for bn in bns:
            bn.recomputing = False


def _rematerialised(block: nn.Module, *args):
    # no block draws random numbers, so the recompute needs no saved RNG
    # state (preserve_rng_state would stash and restore it for each block)
    return checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recomputing(block)))


def unet(n_channels=1, n_classes=3, bilinear=False, **kw) -> UNet:
    """Standard UNet, widths 64..1024."""
    return UNet(n_channels, n_classes, bilinear, widths=(64, 128, 256, 512, 1024),
                name="unet", **kw)


def unet_t(n_channels=1, n_classes=3, bilinear=False, **kw) -> UNet:
    """Tiny UNet, widths 8..128."""
    return UNet(n_channels, n_classes, bilinear, widths=(8, 16, 32, 64, 128),
                name="unet_t", **kw)


def unet_s(n_channels=1, n_classes=3, bilinear=False, **kw) -> UNet:
    """Small UNet, widths 16..256: the default model."""
    return UNet(n_channels, n_classes, bilinear, widths=(16, 32, 64, 128, 256),
                name="unet_s", **kw)


def unet_sa(n_channels=1, n_classes=3, bilinear=False, **kw) -> UNet:
    """unet_s widths with spatial attention on every Up."""
    return UNet(n_channels, n_classes, bilinear, widths=(16, 32, 64, 128, 256),
                use_attention=True, name="unet_sa", **kw)


MODEL_REGISTRY = {"unet": unet, "unet_t": unet_t, "unet_s": unet_s, "unet_sa": unet_sa}


def _extra_registry() -> dict:
    from .unet_nested import unet_pp, unet_pp_s
    from .yolov8_seg import yolov8_seg_s

    return {"unet_pp": unet_pp, "unet_pp_s": unet_pp_s, "yolov8_seg_s": yolov8_seg_s}


def get_model(name: str, **kw) -> nn.Module:
    """The model ``name`` of the UNet family, UNet++ (``unet_pp``,
    ``unet_pp_s``) or YOLOv8-seg (``yolov8_seg_s``), built with ``kw``."""
    registry = dict(MODEL_REGISTRY)
    if name not in registry:
        registry.update(_extra_registry())
    if name not in registry:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODEL_REGISTRY) + ['unet_pp', 'unet_pp_s', 'yolov8_seg_s']}")
    return registry[name](**kw)
