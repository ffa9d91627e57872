"""Plain float32 reference of TransUNet, the R50-ViT-B/16 hybrid
(arXiv:2102.04306; github.com/Beckschen/TransUNet, ``networks/vit_seg_modeling.py``,
``networks/vit_seg_modeling_resnet_skip.py``, ``networks/vit_seg_configs.py:
get_r50_b16_config``), written out over a state_dict in the published layout
with ``torch.nn.functional`` on NCHW tensors.  It imports nothing of the port.

As published: a 1-channel input repeated to 3 channels; every ResNet conv a
StdConv2d (its weight standardised over (Cin, kh, kw) by the mean and the
biased variance, eps 1e-5) without bias; root 7x7 stride 2 + GroupNorm(32,
eps 1e-6) + ReLU, max pool 3x3 stride 2 without padding; pre-activation
bottlenecks (1x1, 3x3 with the stride, 1x1, each with GroupNorm, a
projected residual where the shape changes, GroupNorm(cout, cout) on it);
block 1's output zero-padded at the bottom and right to H / 4; a 1x1 patch
embedding with bias, position embeddings; pre-norm blocks of 12-head
attention ``softmax(q kᵀ / sqrt(d)) v`` and an exact-GELU MLP, LayerNorm eps
1e-6; the cascaded upsampler of Conv2dReLU (3x3 conv without bias, BN, ReLU)
blocks after x2 bilinear upsamples with ``align_corners=True`` and the
concat ``[up, skip]``; a 3x3 head conv with bias.

Departures: dropout is left out (the published rates act in training
only; the reference's forward is the eval one, and the train forward with
``train=True`` is the dropout-0 one); the 127 -> 128 skip pad is ``F.pad``
where the published code copies into a zero tensor (the same values).  An image
of another size than the preset's (H and W multiples of 16) gets the
position embeddings resampled to its token grid as the published
``load_from`` resamples pretrained ones (``ndimage.zoom``, order 1, which
samples as ``align_corners=True``); at the preset's size they are added as
stored.  BN
runs on its running statistics unless ``train`` (batch statistics, the
running ones moved in place by torch's momentum) or ``set_bn_stats``.
TF32 is off wherever :func:`no_tf32` is entered.

The preset's sizes come from the configuration's ``model`` name
(:data:`PRESETS`): a configuration file states no transformer size.

``quant="fp8"`` rounds every conv's and every matmul's inputs and output to
float8 e4m3 under a per-tensor scale (``reference/unet.py``'s ``_q``): the
precision one step below bf16.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.unet import _q, no_tf32, normalize_uint8

__all__ = ["PRESETS", "preset", "state_dict_shapes", "parameter_count", "make_state_dict",
           "calibrate_bn", "no_tf32", "normalize_uint8", "forward"]

PRESETS = {
    "transunet_r50_b16": dict(img_size=512, units=(3, 4, 9), width=64, hidden=768, heads=12,
                              layers=12, mlp_dim=3072, head_channels=512,
                              decoder_channels=(256, 128, 64, 16), n_skip=3, groups=32),
    "transunet_tiny": dict(img_size=64, units=(1, 1, 1), width=8, hidden=32, heads=2, layers=2,
                           mlp_dim=64, head_channels=32, decoder_channels=(16, 16, 8, 8),
                           n_skip=3, groups=4),
}
_GN_EPS = 1e-6
_LN_EPS = 1e-6
_STD_EPS = 1e-5
_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1
_R = "transformer.embeddings.hybrid_model"


def preset(cfg: dict) -> dict:
    """The sizes of the configuration's model, with its skip channels."""
    p = dict(PRESETS[cfg["model"]])
    outs = [p["width"] * 4 * 2 ** i for i in range(len(p["units"]))]
    skips = [*outs[-2::-1], p["width"], 0][:len(p["decoder_channels"])]
    p["skips"] = [c if i < p["n_skip"] else 0 for i, c in enumerate(skips)]
    p["outs"] = outs
    return p


def _units(p: dict):
    """(prefix, cin, cout, cmid, stride) of every bottleneck unit."""
    cin = p["width"]
    for i, n in enumerate(p["units"]):
        cout, cmid = p["width"] * 4 * 2 ** i, p["width"] * 2 ** i
        for j in range(n):
            yield (f"{_R}.body.block{i + 1}.unit{j + 1}", cin if j == 0 else cout, cout, cmid,
                   (1 if i == 0 else 2) if j == 0 else 1)
        cin = cout


def state_dict_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind) of the published state_dict, in its order."""
    p = preset(cfg)
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    w, d = p["width"], p["hidden"]

    def gn(name, c):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = ((c,), "norm_weight"), ((c,), "bias")

    shapes["transformer.embeddings.position_embeddings"] = (
        (1, (p["img_size"] // 16) ** 2, d), "posemb")
    shapes[f"{_R}.root.conv.weight"] = ((w, 3, 7, 7), "std_conv")
    gn(f"{_R}.root.gn", w)
    for prefix, cin, cout, cmid, stride in _units(p):
        gn(f"{prefix}.gn1", cmid)
        shapes[f"{prefix}.conv1.weight"] = ((cmid, cin, 1, 1), "std_conv")
        gn(f"{prefix}.gn2", cmid)
        shapes[f"{prefix}.conv2.weight"] = ((cmid, cmid, 3, 3), "std_conv")
        gn(f"{prefix}.gn3", cout)
        shapes[f"{prefix}.conv3.weight"] = ((cout, cmid, 1, 1), "std_conv")
        if stride != 1 or cin != cout:
            shapes[f"{prefix}.downsample.weight"] = ((cout, cin, 1, 1), "std_conv")
            gn(f"{prefix}.gn_proj", cout)
    shapes["transformer.embeddings.patch_embeddings.weight"] = ((d, p["outs"][-1], 1, 1), "linear")
    shapes["transformer.embeddings.patch_embeddings.bias"] = ((d,), "bias")
    for i in range(p["layers"]):
        b = f"transformer.encoder.layer.{i}"
        gn(f"{b}.attention_norm", d)
        gn(f"{b}.ffn_norm", d)
        for name, cin, cout in (("ffn.fc1", d, p["mlp_dim"]), ("ffn.fc2", p["mlp_dim"], d),
                                ("attn.query", d, d), ("attn.key", d, d), ("attn.value", d, d),
                                ("attn.out", d, d)):
            shapes[f"{b}.{name}.weight"] = ((cout, cin), "linear")
            shapes[f"{b}.{name}.bias"] = ((cout,), "bias")
    gn("transformer.encoder.encoder_norm", d)

    def conv_relu(name, cin, cout):
        shapes[f"{name}.0.weight"] = ((cout, cin, 3, 3), "conv")
        for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
            shapes[f"{name}.1.{leaf}"] = (() if leaf == "num_batches_tracked" else (cout,),
                                          f"bn_{leaf}")

    conv_relu("decoder.conv_more", d, p["head_channels"])
    ins = [p["head_channels"], *p["decoder_channels"][:-1]]
    for i, (cin, cout, skip) in enumerate(zip(ins, p["decoder_channels"], p["skips"])):
        conv_relu(f"decoder.blocks.{i}.conv1", cin + skip, cout)
        conv_relu(f"decoder.blocks.{i}.conv2", cout, cout)
    shapes["segmentation_head.0.weight"] = ((cfg["n_classes"], p["decoder_channels"][-1], 3, 3),
                                            "head")
    shapes["segmentation_head.0.bias"] = ((cfg["n_classes"],), "bias")
    return shapes


def parameter_count(cfg: dict) -> int:
    """Parameters of the model (the BN running statistics left out)."""
    return sum(math.prod(s) for s, kind in state_dict_shapes(cfg).values()
               if kind not in ("bn_running_mean", "bn_running_var", "bn_num_batches_tracked"))


@torch.no_grad()
def make_state_dict(cfg: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights in the published layout, made on ``device`` from one
    normal draw: StdConv weights n (their scale is standardised away), the
    decoder's convs He-scaled (sqrt(2 / fan_in)), linears, the patch
    embedding and the head sqrt(1 / fan_in), position embeddings 0.02 * n,
    norm and BN gammas 1 + 0.1 * n, biases and betas 0.1 * n, BN running
    mean 0.1 * n and running variance exp(0.2 * n)."""
    shapes = state_dict_shapes(cfg)
    floats = [s for s, kind in shapes.values() if kind != "bn_num_batches_tracked"]
    draw = torch.randn(sum(math.prod(s) for s in floats), generator=generator, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, (shape, kind) in shapes.items():
        if kind == "bn_num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = draw[at:at + math.prod(shape)].view(shape)
        at += math.prod(shape)
        fan_in = math.prod(shape[1:]) if len(shape) > 1 else 1
        if kind == "conv":
            t = n * (2.0 / fan_in) ** 0.5
        elif kind in ("linear", "head"):
            t = n * (1.0 / fan_in) ** 0.5
        elif kind == "posemb":
            t = 0.02 * n
        elif kind in ("norm_weight", "bn_weight"):
            t = 1.0 + 0.1 * n
        elif kind == "bn_running_var":
            t = torch.exp(0.2 * n)
        elif kind == "std_conv":
            t = n
        else:  # biases, BN beta, running mean
            t = 0.1 * n
        out[name] = t.contiguous()
    return out


@torch.no_grad()
def calibrate_bn(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor) -> None:
    """Set every BN's running statistics to its batch statistics on the f32
    images ``x``, layer by layer, as a trained model's BN would hold them."""
    with no_tf32():
        forward(sd, cfg, x, set_bn_stats=True)


def _std(w: torch.Tensor) -> torch.Tensor:
    var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (w - mean) / torch.sqrt(var + _STD_EPS)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, train: bool = False,
            quant: Optional[str] = None, set_bn_stats: bool = False) -> torch.Tensor:
    """f32 logits (B, H, W, n_classes) of f32 images (B, H, W) or (B, H, W, C)."""
    p = preset(cfg)
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    x = x.permute(0, 3, 1, 2).float()
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    height, width = x.shape[-2:]

    def q(t):
        return _q(t, quant)

    def conv(x, w, b=None, stride=1, padding=0):
        y = q(F.conv2d(q(x), q(w), None, stride=stride, padding=padding))
        return y if b is None else y + b.view(1, -1, 1, 1)

    def linear(x, name):
        return q(q(x) @ q(sd[f"{name}.weight"]).t()) + sd[f"{name}.bias"]

    def gn(x, name, groups, eps=_GN_EPS):
        return F.group_norm(x, groups, sd[f"{name}.weight"], sd[f"{name}.bias"], eps)

    def ln(x, name):
        return F.layer_norm(x, x.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], _LN_EPS)

    g = p["groups"]
    y = F.relu(gn(conv(x, _std(sd[f"{_R}.root.conv.weight"]), stride=2, padding=3),
                  f"{_R}.root.gn", g))
    skips = [y]
    y = F.max_pool2d(y, 3, 2)
    block = None
    for prefix, cin, cout, cmid, stride in _units(p):
        here = prefix.rsplit(".", 1)[0]
        if block is not None and here != block and len(skips) < len(p["units"]):
            skips.append(_pad_to(y, height // 4 // len(skips), width // 4 // len(skips)))
        block = here
        r = y
        if stride != 1 or cin != cout:
            r = gn(conv(y, _std(sd[f"{prefix}.downsample.weight"]), stride=stride),
                   f"{prefix}.gn_proj", cout, 1e-5)
        h = F.relu(gn(conv(y, _std(sd[f"{prefix}.conv1.weight"])), f"{prefix}.gn1", g))
        h = F.relu(gn(conv(h, _std(sd[f"{prefix}.conv2.weight"]), stride=stride, padding=1),
                      f"{prefix}.gn2", g))
        h = gn(conv(h, _std(sd[f"{prefix}.conv3.weight"])), f"{prefix}.gn3", g)
        y = F.relu(r + h)
    e = "transformer.embeddings"
    y = conv(y, sd[f"{e}.patch_embeddings.weight"], sd[f"{e}.patch_embeddings.bias"])
    t = y.flatten(2).transpose(1, 2) + _position_embeddings(sd[f"{e}.position_embeddings"],
                                                            p["img_size"] // 16, *y.shape[-2:])
    heads, d = p["heads"], p["hidden"] // p["heads"]
    for i in range(p["layers"]):
        b = f"transformer.encoder.layer.{i}"
        a = ln(t, f"{b}.attention_norm")
        qh, kh, vh = (linear(a, f"{b}.attn.{n}").view(a.shape[0], -1, heads, d).transpose(1, 2)
                      for n in ("query", "key", "value"))
        probs = torch.softmax(q(q(qh) @ q(kh).transpose(-1, -2)) / math.sqrt(d), dim=-1)
        ctx = q(q(probs) @ q(vh)).transpose(1, 2).reshape(t.shape)
        t = t + linear(ctx, f"{b}.attn.out")
        m = F.gelu(linear(ln(t, f"{b}.ffn_norm"), f"{b}.ffn.fc1"))
        t = t + linear(m, f"{b}.ffn.fc2")
    t = ln(t, "transformer.encoder.encoder_norm")
    y = t.transpose(1, 2).reshape(t.shape[0], p["hidden"], height // 16, width // 16)

    def conv_relu(y, name):
        y = conv(y, sd[f"{name}.0.weight"], padding=1)
        bn = f"{name}.1"
        y = F.batch_norm(y, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"], sd[f"{bn}.weight"],
                         sd[f"{bn}.bias"], training=train or set_bn_stats,
                         momentum=1.0 if set_bn_stats else _BN_MOMENTUM, eps=_BN_EPS)
        return F.relu(y)

    y = conv_relu(y, "decoder.conv_more")
    skips = skips[::-1]
    for i in range(len(p["decoder_channels"])):
        y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
        if i < p["n_skip"]:
            y = torch.cat([y, skips[i]], dim=1)
        y = conv_relu(conv_relu(y, f"decoder.blocks.{i}.conv1"), f"decoder.blocks.{i}.conv2")
    y = conv(y, sd["segmentation_head.0.weight"], sd["segmentation_head.0.bias"], padding=1)
    return y.permute(0, 2, 3, 1)


def _pad_to(y: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Zero-pad an NCHW map at the bottom and right to (height, width) (the
    published ``feat``)."""
    return F.pad(y, [0, width - y.shape[3], 0, height - y.shape[2]])


def _position_embeddings(pe: torch.Tensor, grid: int, gh: int, gw: int) -> torch.Tensor:
    """(1, grid², hidden) position embeddings on a (gh, gw) token grid."""
    if (gh, gw) == (grid, grid):
        return pe
    g = pe.reshape(1, grid, grid, -1).permute(0, 3, 1, 2)
    g = F.interpolate(g, size=(gh, gw), mode="bilinear", align_corners=True)
    return g.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
