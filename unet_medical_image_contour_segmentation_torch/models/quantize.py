"""Post-training int8 quantisation of the UNet family's eval forward.

The port of the JAX package's ``models/quantize.py`` for the UNet family
(unet, unet_t, unet_s, unet_sa, bilinear or ConvTranspose ups), on NHWC
tensors in place of the wide layout.  ``Predictor(quantize=True)`` serves
through it.  The scheme is JAX's:

* **Weights**: symmetric per-output-channel int8, quantised from the f32
  BN-folded kernels with each input part's activation scale folded into the
  kernel's Cin slice first (``w_eff = w * s_in[ci]``), so the decoder's
  concatenated (skip, upsample) input needs no per-part rescale.  Each int8
  weight is stored once in the kernel's packed form
  (``kernels/conv3x3_int8.py:pack_weight``).
* **Activations**: symmetric per-tensor scales, ``amax / 127``, from one
  float forward with amax taps on every quantised conv's input and output;
  per-tensor, so one calibration serves every input size.
* **Placement**, by position: every 3x3 DoubleConv conv runs int8 on the
  kernel; each Up's conv1 takes the int8 skip and upsample as the two parts
  of a split input, as JAX's ``conv_wide_split_int8`` does.  inc and down1..down3 requantise both convs to int8 (the max pool
  and the skips are scale-preserving); down4's conv2 and every Up's conv2
  dequantise straight to the compute dtype; every Up's conv1 requantises.
  ConvTranspose, the bilinear upsample, the attention gate (on the
  dequantised skip, requantised with the skip's own scale: the gate is in
  (0, 1)) and the 1x1 head stay in the float compute dtype.

The qparams are a plain nested dict with the JAX tree's keys: ``s_x``,
``inc/conv1/{w, mul, badd}``, ..., ``up{i}/{conv, s_up, upconv, att,
s_skip}``, ``outc``.  :func:`apply_int8` returns f32 NHWC logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.conv3x3_int8 import conv3x3_int8, pack_weight
from ..ops.nn import conv2d, conv_transpose2d, max_pool2d
from ..ops.resize import upsample_x2_align_corners
from .blocks import attention_gate

__all__ = ["folded_tree", "calibrate_amax", "build_qparams", "quantize_unet", "apply_int8"]

_ENCODER = ("inc", "down1", "down2", "down3", "down4")


def _amax(t: torch.Tensor) -> torch.Tensor:
    return t.float().abs().amax()


def _quant_sym(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """float -> int8 on the symmetric grid with scale ``s`` (a 0-dim f32
    tensor on x's device: a true division, as JAX's)."""
    return torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)


def _max_pool_int8(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, floor mode, of an int8 NHWC tensor, staying int8 (the
    encoder's pools are scale-preserving): a max over a (2, 2) view."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _qconv(x: torch.Tensor, entry: dict, out_dtype: torch.dtype,
           x2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The int8 conv and its epilogue (JAX ``_qconv``): ``out_dtype`` int8
    requantises, a float dtype dequantises.  ``x2``: the second part of a
    split input (JAX ``conv_wide_split_int8``), summed with x in one conv."""
    return conv3x3_int8(x.contiguous(), entry["w"], entry["mul"], entry["badd"], out_dtype,
                        None if x2 is None else x2.contiguous())


def folded_tree(net: nn.Module) -> dict:
    """A UNet folded by ``models/fold_bn.py:fold_bn`` -> its tensors in the
    JAX package's folded-params tree: ``{inc: {conv1: {w, b}, conv2: {w, b}},
    down1.., up{i}: {conv, upconv: {w, b}, att: {conv: {w}}}, outc: {w, b}}``,
    weights HWIO (views of the module's tensors, no copies)."""
    def dc(m):
        return {"conv1": {"w": m.w1, "b": m.b1}, "conv2": {"w": m.w2, "b": m.b2}}

    tree = {"inc": dc(net.inc)}
    for i in range(1, 5):
        tree[f"down{i}"] = dc(getattr(net, f"down{i}").maxpool_conv[1])
    for i in range(1, 5):
        up = getattr(net, f"up{i}")
        entry = {"conv": dc(up.conv)}
        if not up.bilinear:
            entry["upconv"] = {"w": up.up.weight.permute(2, 3, 0, 1), "b": up.up.bias}
        if hasattr(up, "attention"):
            entry["att"] = {"conv": {"w": up.attention.conv1.weight.permute(2, 3, 1, 0)}}
        tree[f"up{i}"] = entry
    tree["outc"] = {"w": net.outc.conv.weight.permute(2, 3, 1, 0), "b": net.outc.conv.bias}
    return tree


def _widths(tree: dict):
    return [int(tree[k]["conv2"]["w"].shape[-1]) for k in _ENCODER]


def _forward(p: dict, x: torch.Tensor, cd: torch.dtype, *, quant: bool,
             amax: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The shared walker: calibration (quant=False, p = a folded tree, fills
    ``amax``) and int8 execution (quant=True, p = qparams).  JAX ``_forward``
    on NHWC: the same levels, the same requant / dequant positions."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)

    def dc(name, sub, xin, *, requant, x2=None):
        if quant:
            y = _qconv(xin, sub["conv1"], torch.int8, x2)
            return _qconv(y, sub["conv2"], torch.int8 if requant else cd)
        y = torch.relu(conv2d(xin, sub["conv1"]["w"], sub["conv1"]["b"], padding=1,
                              compute_dtype=cd))
        amax[f"{name}.c1"] = _amax(y)
        y = torch.relu(conv2d(y, sub["conv2"]["w"], sub["conv2"]["b"], padding=1,
                              compute_dtype=cd))
        amax[f"{name}.c2"] = _amax(y)
        return y

    pool = _max_pool_int8 if quant else max_pool2d
    # -- encoder: inc..down3 requantise, down4 dequantises (its only consumer
    # is the float up1 upsample / ConvTranspose)
    if quant:
        x = _quant_sym(x, p["s_x"])
    else:
        amax["x"] = _amax(x)
    cur = dc("inc", p["inc"], x, requant=True)
    feats = [cur]
    for i in range(1, 5):
        cur = dc(f"down{i}", p[f"down{i}"], pool(cur), requant=i < 4)
        if i < 4:
            feats.append(cur)

    # -- decoder: float upsample, quantised with its own scale; the int8
    # [skip, up] input as two parts of one split conv (no concatenated copy)
    y = cur
    for i in range(1, 5):
        skip, up = feats[4 - i], p[f"up{i}"]
        if "upconv" in up:
            y = conv_transpose2d(y.to(cd), up["upconv"]["w"], up["upconv"].get("b"), stride=2,
                                 compute_dtype=cd)
        else:
            y = upsample_x2_align_corners(y.to(cd))
        if quant:
            y = _quant_sym(y, up["s_up"])
        else:
            amax[f"up{i}.up"] = _amax(y)
        if "att" in up:
            w_att = up["att"]["conv"]["w"]
            if quant:  # the gate on the dequantised skip, requantised with its scale
                skip_f = (skip.float() * up["s_skip"]).to(cd)
                skip = _quant_sym(skip_f * attention_gate(skip_f, w_att, cd), up["s_skip"])
            else:
                skip = skip * attention_gate(skip, w_att, cd)
        if quant:
            y = dc(f"up{i}", up["conv"], skip, requant=False, x2=y)
        else:
            y = dc(f"up{i}", up["conv"], torch.cat([skip, y.to(skip.dtype)], dim=-1),
                   requant=False)

    # -- head (1x1 conv, float)
    return conv2d(y.to(cd), p["outc"]["w"], p["outc"].get("b"), compute_dtype=cd).float()


@torch.inference_mode()
def calibrate_amax(folded: dict, images: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The float eval forward of ``folded`` (a :func:`folded_tree`) with amax
    taps, in ``compute_dtype`` (f32 when None), on ``images`` (B, H, W[, C])
    float with H, W multiples of 16 -> {tap name: amax} as Python floats."""
    amax: Dict[str, torch.Tensor] = {}
    _forward(folded, images, compute_dtype or torch.float32, quant=False, amax=amax)
    values = torch.stack(list(amax.values())).tolist()
    return dict(zip(amax, values))


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _quantize_kernel(w, b, s_in, s_out, device) -> dict:
    """HWIO kernel + bias -> {w: packed int8, mul, badd} with the input scales
    folded in; ``s_out`` the output scale (requant) or None (dequant).  In
    numpy f32, line for line the JAX package's ``_quantize_kernel``."""
    w = _numpy(w).astype(np.float32)
    b = _numpy(b).astype(np.float32)
    w_eff = w * np.asarray(s_in, np.float32)[None, None, :, None]
    s_w = np.maximum(np.abs(w_eff).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    w_q = np.clip(np.round(w_eff / s_w), -127, 127).astype(np.int8)
    if s_out is None:
        mul, badd = s_w, b
    else:
        mul, badd = s_w / s_out, b / s_out
    return {"w": pack_weight(torch.from_numpy(w_q)).to(device),
            "mul": torch.from_numpy(np.asarray(mul, np.float32)).to(device),
            "badd": torch.from_numpy(np.asarray(badd, np.float32)).to(device)}


def _scalar(s: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(s), device=device)


def _float_tensors(tree, device):
    """A subtree of float tensors (ConvT, attention, head) as f32 on ``device``."""
    if isinstance(tree, dict):
        return {k: _float_tensors(v, device) for k, v in tree.items() if v is not None}
    return tree.detach().float().to(device).contiguous()


def build_qparams(folded: dict, amax: Dict[str, float], device=None) -> dict:
    """An f32 :func:`folded_tree` + calibration amaxes -> the int8 qparams on
    ``device`` (the folded tensors' device when None).  JAX ``build_qparams``."""
    device = device if device is not None else folded["inc"]["conv1"]["w"].device
    s = {k: max(v, 1e-12) / 127.0 for k, v in amax.items()}

    def dc_entry(name, sub, s_in_vec, requant_out):
        c1 = _quantize_kernel(sub["conv1"]["w"], sub["conv1"]["b"], s_in_vec,
                              s[f"{name}.c1"], device)
        cin2 = sub["conv2"]["w"].shape[2]
        c2 = _quantize_kernel(sub["conv2"]["w"], sub["conv2"]["b"],
                              np.full(cin2, s[f"{name}.c1"], np.float32),
                              s[f"{name}.c2"] if requant_out else None, device)
        return {"conv1": c1, "conv2": c2}

    qp = {"s_x": _scalar(s["x"], device), "outc": _float_tensors(folded["outc"], device)}
    cin0 = folded["inc"]["conv1"]["w"].shape[2]
    qp["inc"] = dc_entry("inc", folded["inc"], np.full(cin0, s["x"], np.float32), True)
    prev = "inc"
    for i in range(1, 5):
        cin = folded[f"down{i}"]["conv1"]["w"].shape[2]
        qp[f"down{i}"] = dc_entry(f"down{i}", folded[f"down{i}"],
                                  np.full(cin, s[f"{prev}.c2"], np.float32), i < 4)
        prev = f"down{i}"

    w = _widths(folded)
    skip_scale_names = ["down3.c2", "down2.c2", "down1.c2", "inc.c2"]
    for i in range(1, 5):
        p_up = folded[f"up{i}"]
        skip_c = w[4 - i]
        s_skip = s[skip_scale_names[i - 1]]
        s_up = s[f"up{i}.up"]
        cin = p_up["conv"]["conv1"]["w"].shape[2]
        s_in = np.concatenate([np.full(skip_c, s_skip, np.float32),
                               np.full(cin - skip_c, s_up, np.float32)])
        conv = p_up["conv"]
        entry = {
            "conv": {
                "conv1": _quantize_kernel(conv["conv1"]["w"], conv["conv1"]["b"], s_in,
                                          s[f"up{i}.c1"], device),
                "conv2": _quantize_kernel(conv["conv2"]["w"], conv["conv2"]["b"],
                                          np.full(conv["conv2"]["w"].shape[2], s[f"up{i}.c1"],
                                                  np.float32), None, device),
            },
            "s_up": _scalar(s_up, device),
        }
        if "upconv" in p_up:
            entry["upconv"] = _float_tensors(p_up["upconv"], device)
        if "att" in p_up:
            entry["att"] = _float_tensors(p_up["att"], device)
            entry["s_skip"] = _scalar(s_skip, device)
        qp[f"up{i}"] = entry
    return qp


def quantize_unet(folded: dict, calib_images: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Calibrate on ``calib_images`` and build, in one call (f32 folded tree)."""
    return build_qparams(folded, calibrate_amax(folded, calib_images, compute_dtype))


@torch.inference_mode()
def apply_int8(qparams: dict, x: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 eval forward: (B, H, W[, C]) float images, H and W multiples
    of 16 -> (B, H, W, n_classes) f32 logits.  The float pieces run in
    ``compute_dtype`` (f32 when None)."""
    return _forward(qparams, x, compute_dtype or torch.float32, quant=True, amax={})
