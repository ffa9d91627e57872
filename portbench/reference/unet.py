"""Plain float32 reference of the UNet family: the reference repository's
``unet/unet_model.py`` (milesial/Pytorch-UNet's UNet with ConvTranspose
ups), written out over a state_dict in its layout with ``torch.nn.functional``
on NCHW tensors.  It imports nothing of the port: it folds no BN (eval mode
runs BN on the running statistics itself), normalises uint8 slices itself
(each slice /255 when its maximum exceeds 1, as the reference's
``BasicDataset.preprocess``), and takes its own train step: cross entropy
plus the global multiclass Dice loss, the global-norm clip and torch's
RMSprop, with every BN's running statistics moved as torch's BN moves them
(momentum 0.1, the unbiased batch variance).  TF32 is off in every function
here.

:func:`make_state_dict` makes the weights the benchmark hands to both sides:
one normal draw on the device for every float tensor, scaled per tensor.

``quant="fp8"`` runs the same arithmetic with every conv's input, weight and
output (the tensors the port holds in bf16) rounded to float8 e4m3 under a
per-tensor scale (amax / 448), and the gradient flowing back into each
rounded tensor rounded to e5m2 under its own scale (amax / 57344): the
precision one step below bf16, the control of the training cell.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["state_dict_shapes", "make_state_dict", "calibrate_bn", "trainable", "bn_stats",
           "no_tf32", "normalize_uint8", "forward", "loss", "Trainer", "train_steps"]

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.1


def _blocks(cfg: dict) -> List[Tuple[str, int, int]]:
    """(state_dict prefix, Cin, Cout) of every DoubleConv, in forward order."""
    w = cfg["widths"]
    out = [("inc.double_conv", cfg["n_channels"], w[0])]
    out += [(f"down{i}.maxpool_conv.1.double_conv", w[i - 1], w[i]) for i in range(1, 5)]
    out += [(f"up{i}.conv.double_conv", w[5 - i], w[4 - i]) for i in range(1, 5)]
    return out


def state_dict_shapes(cfg: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, kind) of the reference's state_dict, in its order."""
    if cfg.get("bilinear") or cfg.get("attention"):
        raise ValueError("this reference covers the ConvTranspose UNet without attention")
    w = cfg["widths"]
    shapes: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def double_conv(prefix: str, cin: int, cout: int) -> None:
        for i, c_in in ((0, cin), (3, cout)):
            shapes[f"{prefix}.{i}.weight"] = ((cout, c_in, 3, 3), "conv")
            for leaf in ("weight", "bias", "running_mean", "running_var", "num_batches_tracked"):
                shapes[f"{prefix}.{i + 1}.{leaf}"] = (() if leaf == "num_batches_tracked"
                                                      else (cout,), f"bn_{leaf}")

    blocks = _blocks(cfg)
    for prefix, cin, cout in blocks[:5]:
        double_conv(prefix, cin, cout)
    for i, (prefix, cin, cout) in enumerate(blocks[5:], 1):
        shapes[f"up{i}.up.weight"] = ((cin, cin // 2, 2, 2), "convt")
        shapes[f"up{i}.up.bias"] = ((cin // 2,), "bias")
        double_conv(prefix, cin, cout)
    shapes["outc.conv.weight"] = ((cfg["n_classes"], w[0], 1, 1), "head")
    shapes["outc.conv.bias"] = ((cfg["n_classes"],), "bias")
    return shapes


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def make_state_dict(cfg: dict, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights in the reference's layout, made on ``device`` from
    one normal draw: convs He-scaled (std sqrt(2 / fan_in)), the ConvTranspose
    and the head sqrt(1 / fan_in), biases 0.1 * n, BN gamma 1 + 0.1 * n and
    beta 0.1 * n, running mean 0.1 * n and running variance exp(0.2 * n)."""
    shapes = state_dict_shapes(cfg)
    floats = [(k, s, kind) for k, (s, kind) in shapes.items() if kind != "bn_num_batches_tracked"]
    draw = torch.randn(sum(_numel(s) for _, s, _ in floats), generator=generator,
                       device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, (shape, kind) in shapes.items():
        if kind == "bn_num_batches_tracked":
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        n = draw[at:at + _numel(shape)].view(shape)
        at += _numel(shape)
        if kind == "conv":
            t = n * (2.0 / _numel(shape[1:])) ** 0.5
        elif kind == "convt":
            t = n * (1.0 / shape[0]) ** 0.5
        elif kind == "head":
            t = n * (1.0 / shape[1]) ** 0.5
        elif kind == "bn_weight":
            t = 1.0 + 0.1 * n
        elif kind == "bn_running_var":
            t = torch.exp(0.2 * n)
        else:  # biases, BN beta, running mean
            t = 0.1 * n
        out[name] = t.contiguous()
    return out


@torch.no_grad()
def calibrate_bn(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor) -> None:
    """Set every BN's running statistics to its batch statistics on the f32
    images ``x``, layer by layer as a trained model's BN would hold them: the
    seeded convs leave each channel an offset that running statistics drawn
    at random would not remove, and the logits of one class would then win
    everywhere."""
    with no_tf32():
        forward(sd, cfg, x, set_bn_stats=True)


def trainable(sd: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the parameters a step trains (no BN running statistics)."""
    return [k for k in sd if not k.endswith(("running_mean", "running_var",
                                              "num_batches_tracked"))]


def bn_stats(sd: Dict[str, torch.Tensor]) -> List[str]:
    """The names of the BN running statistics a train step moves."""
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def normalize_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W) -> f32, each slice /255 when its maximum exceeds 1."""
    xf = x.float()
    mx = xf.amax(dim=(1, 2), keepdim=True)
    return xf / torch.where(mx > 1, 255.0, 1.0)


class _Fp8(torch.autograd.Function):
    """Round to e4m3 under a per-tensor scale; the gradient to e5m2 likewise."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


def _q(x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    if quant is None:
        return x
    if quant != "fp8":
        raise ValueError(f"unknown quant {quant!r}")
    return _Fp8.apply(x)


def forward(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, train: bool = False,
            quant: Optional[str] = None, set_bn_stats: bool = False) -> torch.Tensor:
    """f32 logits (B, H, W, n_classes) of f32 images (B, H, W) or (B, H, W, C):
    BN on the batch statistics when ``train``, which move the running ones
    in ``sd`` in place by torch's momentum, else on the running ones.
    ``set_bn_stats``: BN on the batch statistics, which also become the
    running ones (in place in ``sd``)."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    x = x.permute(0, 3, 1, 2).float()

    def conv(x, w, b=None):
        y = F.conv2d(_q(x, quant), _q(w, quant), None, padding=w.shape[-1] // 2)
        y = _q(y, quant)
        return y if b is None else y + b.view(1, -1, 1, 1)

    def double_conv(prefix: str, x):
        for i in (0, 3):
            x = conv(x, sd[f"{prefix}.{i}.weight"])
            bn = f"{prefix}.{i + 1}"
            x = F.batch_norm(x, sd[f"{bn}.running_mean"], sd[f"{bn}.running_var"],
                             sd[f"{bn}.weight"], sd[f"{bn}.bias"], training=train or set_bn_stats,
                             momentum=1.0 if set_bn_stats else _BN_MOMENTUM, eps=_BN_EPS)
            x = F.relu(x)
        return x

    blocks = [p for p, _, _ in _blocks(cfg)]
    skips = [double_conv(blocks[0], x)]
    for prefix in blocks[1:5]:
        skips.append(double_conv(prefix, F.max_pool2d(skips[-1], 2)))
    y = skips.pop()
    for i, prefix in enumerate(blocks[5:], 1):
        skip = skips.pop()
        y = _q(F.conv_transpose2d(_q(y, quant), _q(sd[f"up{i}.up.weight"], quant),
                                  stride=2), quant) + sd[f"up{i}.up.bias"].view(1, -1, 1, 1)
        dh, dw = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
        y = F.pad(y, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        y = double_conv(prefix, torch.cat([skip, y], dim=1))
    y = conv(y, sd["outc.conv.weight"], sd["outc.conv.bias"])
    return y.permute(0, 2, 3, 1)


def loss(logits: torch.Tensor, mask: torch.Tensor, n_classes: int, eps: float) -> torch.Tensor:
    """Mean cross entropy plus 1 - one global Dice of softmax against one-hot
    (an empty pair scores 1)."""
    ce = F.cross_entropy(logits.reshape(-1, n_classes), mask.reshape(-1).long())
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(mask.long(), n_classes).float()
    inter = 2 * (probs * onehot).sum()
    sets = probs.sum() + onehot.sum()
    sets = torch.where(sets == 0, inter, sets)
    return ce + 1.0 - (inter + eps) / (sets + eps)


class Trainer:
    """The reference's training state on a copy of ``sd``: f32 parameters,
    torch's RMSprop over them and the BN running statistics; :meth:`step`
    takes one step."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict, mix: dict,
                 quant: Optional[str] = None):
        self.cfg, self.mix, self.quant = cfg, mix, quant
        self.params = {k: sd[k].detach().clone().requires_grad_(True) for k in trainable(sd)}
        self.state = dict(sd)
        self.state.update(self.params)
        self.state.update({k: sd[k].detach().clone() for k in bn_stats(sd)})
        o = mix["optimizer"]
        self.optimizer = torch.optim.RMSprop(
            list(self.params.values()), lr=o["learning_rate"], alpha=o["alpha"], eps=o["eps"],
            weight_decay=o["weight_decay"], momentum=o["momentum"], foreach=False)

    def step(self, image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """One step on (image f32 (B, H, W[, 1]), mask int (B, H, W)); the loss."""
        with no_tf32():
            logits = forward(self.state, self.cfg, image, train=True, quant=self.quant)
            value = loss(logits, mask, self.cfg["n_classes"], self.mix["loss"]["dice_epsilon"])
            self.optimizer.zero_grad(set_to_none=True)
            value.backward()
            grads = [p.grad for p in self.params.values()]
            total = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
            coef = (self.mix["gradient_clipping"] / (total + 1e-6)).clamp(max=1.0)
            for g in grads:
                g.mul_(coef)
            self.optimizer.step()
        return value.detach()

    def grad_norms(self) -> Dict[str, float]:
        """Each parameter's norm of the first gradient as RMSprop took it,
        from its ``square_avg`` after one step."""
        alpha = self.mix["optimizer"]["alpha"]
        return {k: float((self.optimizer.state[p]["square_avg"].sum() / (1.0 - alpha)).sqrt())
                for k, p in self.params.items()}


def train_steps(sd: Dict[str, torch.Tensor], cfg: dict, batches, mix: dict,
                quant: Optional[str] = None) -> dict:
    """Train a copy of ``sd`` on ``batches`` ((image, mask) on the device), one
    step each: the ``losses``, the first gradient's norms (``grad_norms``),
    each parameter's norm of change over all the steps (``change_norms``) and
    each BN running statistic's (``bn_change_norms``)."""
    trainer = Trainer(sd, cfg, mix, quant)
    losses, grads = [], None
    for image, mask in batches:
        losses.append(float(trainer.step(image, mask)))
        if grads is None:
            grads = trainer.grad_norms()
    change = {k: float((p.detach() - sd[k]).norm()) for k, p in trainer.params.items()}
    bn = {k: float((trainer.state[k] - sd[k]).norm()) for k in bn_stats(sd)}
    return {"losses": losses, "grad_norms": grads, "change_norms": change,
            "bn_change_norms": bn}
