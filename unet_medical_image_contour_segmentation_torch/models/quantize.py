"""Post-training int8 quantisation of the UNet family's and UNet++'s eval forward.

The port of the JAX package's ``models/quantize.py`` for the UNet family
(unet, unet_t, unet_s, unet_sa, bilinear or ConvTranspose ups) and UNet++
(unet_pp_s, unet_pp; bilinear, deep supervision), on NHWC tensors in place
of the wide layout.  ``Predictor(quantize=True)`` serves through it.  The
YOLOv8-seg walker (JAX ``_forward_yolo``) is not ported.  The scheme is
JAX's:

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

UNet++ (JAX ``_forward_pp``): every node's DoubleConv runs int8; a nested
node's conv1 takes its j int8 skips concatenated (a copy of int8 bytes) as
the kernel's ``x`` and the int8 upsample as ``x2``, exact since the int32
sums do not depend on how K is split and each part's input scale is folded
into its Cin slice of the weight.  A node with a later int8 consumer (a
same-depth skip, or the max pool below it) requantises (``_pp_requant``);
the others dequantise in the kernel's epilogue to the compute dtype.  The
up path (ConvTranspose or bilinear, float) runs on the dequantised source
node and is quantised with its own scale; the heads read their nodes
dequantised.

The qparams are a plain nested dict with the JAX tree's keys: ``s_x``,
``inc/conv1/{w, mul, badd}``, ..., ``up{i}/{conv, s_up, upconv, att,
s_skip}``, ``outc`` for the UNet family; ``s_x``, ``s_nodes``, ``s_ups``,
``x{i}_{j}/conv{1,2}``, ``up{i}_{j}``, ``outc`` or ``out{j}`` for UNet++.
The walker follows the tree's keys (JAX ``_walker_for``), and
:func:`apply_int8` returns f32 NHWC logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..kernels.conv3x3_int8 import conv3x3_int8, pack_weight
from ..ops.nn import conv2d, conv_transpose2d, max_pool2d
from ..ops.resize import upsample_x2_align_corners
from .blocks import DoubleConv, attention_gate

__all__ = ["folded_tree", "calibrate_amax", "build_qparams", "build_qparams_pp",
           "quantize_unet", "apply_int8", "refuse_int8"]

_ENCODER = ("inc", "down1", "down2", "down3", "down4")


def refuse_int8(model: nn.Module) -> None:
    """Raise NotImplementedError for a model the port has no int8 path for
    (YOLOv8-seg: no DoubleConv); the UNet family and UNet++ pass."""
    if not any(isinstance(m, DoubleConv) for m in model.modules()):
        raise NotImplementedError(
            f"int8 serving of {getattr(model, 'name', type(model).__name__)} is not ported to "
            "the PyTorch package yet: it needs the int8 kernel's SiLU epilogue on a signed "
            "grid, stride-2 and 1x1 int8 convs, residual requant-adds and the int8 SPPF pool "
            "(the JAX package's models/quantize.py:_forward_yolo); serve it in float")


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


def _folded_dc(m) -> dict:
    return {"conv1": {"w": m.w1, "b": m.b1}, "conv2": {"w": m.w2, "b": m.b2}}


def _head(m) -> dict:
    return {"w": m.conv.weight.permute(2, 3, 1, 0), "b": m.conv.bias}


def folded_tree(net: nn.Module) -> dict:
    """A UNet or UNet++ folded by ``models/fold_bn.py:fold_bn`` -> its tensors
    in the JAX package's folded-params tree, weights HWIO (views of the
    module's tensors, no copies): ``{inc: {conv1: {w, b}, conv2: {w, b}},
    down1.., up{i}: {conv, upconv: {w, b}, att: {conv: {w}}}, outc: {w, b}}``
    for the UNet family, ``{x{i}_{j}: {conv1, conv2}, up{i}_{j}: {w, b},
    outc or out{j}: {w, b}}`` for UNet++."""
    dc = _folded_dc
    if hasattr(net, "x0_0"):  # UNet++
        tree = {}
        for name, m in net.named_children():
            if name.startswith("x"):
                tree[name] = dc(m)
            elif name.startswith("up"):
                tree[name] = {"w": m.weight.permute(2, 3, 0, 1), "b": m.bias}
            else:
                tree[name] = _head(m)
        return tree

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
    tree["outc"] = _head(net.outc)
    return tree


def _widths(tree: dict):
    return [int(tree[k]["conv2"]["w"].shape[-1]) for k in _ENCODER]


def _make_dc(cd: torch.dtype, quant: bool, amax: Dict[str, torch.Tensor]):
    """The DoubleConv runner the walkers share (JAX ``_make_dc``):
    ``dc(name, sub, xin, requant=, x2=None)`` runs two int8 convs from a
    qparams entry (the first on the split input ``xin`` + ``x2`` when x2 is
    given), or in calibration the folded float convs, filling ``amax``."""

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

    return dc


def _forward(p: dict, x: torch.Tensor, cd: torch.dtype, *, quant: bool,
             amax: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The UNet family's walker: calibration (quant=False, p = a folded tree,
    fills ``amax``) and int8 execution (quant=True, p = qparams).  JAX
    ``_forward`` on NHWC: the same levels, the same requant / dequant
    positions."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    dc = _make_dc(cd, quant, amax)
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


def _pp_requant(d: int, i: int, j: int) -> bool:
    """Does UNet++ node X[i][j] have a later int8 consumer?  Same-depth skips
    X[i][j'] (j' > j) exist iff j < d-1-i; they, and the max pool to
    X[i+1][0], read int8.  The other consumers (the up path, the heads) are
    float and read the node dequantised."""
    return j < d - 1 - i


def _pp_depth(p: dict) -> int:
    return sum(1 for k in p if k.startswith("x") and k.endswith("_0"))


def _forward_pp(p: dict, x: torch.Tensor, cd: torch.dtype, *, quant: bool,
                amax: Dict[str, torch.Tensor]) -> torch.Tensor:
    """UNet++'s walker (JAX ``_forward_pp`` on NHWC): every node's DoubleConv
    int8 with the per-part input scales folded into the weight; the up path
    float on the dequantised source node, quantised with its own scale; a
    nested node's conv1 takes its int8 skips concatenated as ``x`` and the
    int8 upsample as ``x2``.  Bilinear when the tree has no ``up0_1``, deep
    supervision when it has no ``outc``."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)
    d, bilinear = _pp_depth(p), "up0_1" not in p
    dc = _make_dc(cd, quant, amax)
    pool = _max_pool_int8 if quant else max_pool2d
    if quant:
        x = _quant_sym(x, p["s_x"])
    else:
        amax["x"] = _amax(x)

    nodes = {}
    for i in range(d):
        inp = x if i == 0 else pool(nodes[(i - 1, 0)])
        nodes[(i, 0)] = dc(f"x{i}_0", p[f"x{i}_0"], inp, requant=_pp_requant(d, i, 0))

    def dequant(i, j):
        t = nodes[(i, j)]
        if quant and _pp_requant(d, i, j):
            t = t.float() * p["s_nodes"][f"x{i}_{j}"]
        return t.to(cd)

    for j in range(1, d):
        for i in range(d - j):
            name, up_name = f"x{i}_{j}", f"up{i}_{j}"
            # the skips X[i][0..j-1] all requantise (k <= j-1 < d-1-i): int8
            skips = [nodes[(i, k)] for k in range(j)]
            src = dequant(i + 1, j - 1)
            if bilinear:
                upped = upsample_x2_align_corners(src)
            else:
                upped = conv_transpose2d(src, p[up_name]["w"], p[up_name].get("b"), stride=2,
                                         compute_dtype=cd)
            rq = _pp_requant(d, i, j)
            if quant:
                xin = skips[0] if j == 1 else torch.cat(skips, dim=-1)
                nodes[(i, j)] = dc(name, p[name], xin, requant=rq,
                                   x2=_quant_sym(upped, p["s_ups"][up_name]))
            else:
                amax[f"{up_name}.up"] = _amax(upped)
                nodes[(i, j)] = dc(name, p[name],
                                   torch.cat(skips + [upped.to(skips[0].dtype)], dim=-1),
                                   requant=rq)

    # -- heads (1x1 convs, float)
    if "outc" in p:
        logits = conv2d(dequant(0, d - 1), p["outc"]["w"], p["outc"].get("b"),
                        compute_dtype=cd)
    else:
        outs = [conv2d(dequant(0, j), p[f"out{j}"]["w"], p[f"out{j}"].get("b"),
                       compute_dtype=cd) for j in range(1, d)]
        logits = sum(outs) / len(outs)
    return logits.float()


def _walker_for(tree: dict):
    return _forward_pp if "x0_0" in tree else _forward


@torch.inference_mode()
def calibrate_amax(folded: dict, images: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The float eval forward of ``folded`` (a :func:`folded_tree`) with amax
    taps, in ``compute_dtype`` (f32 when None), on ``images`` (B, H, W[, C])
    float with H, W multiples of 16 -> {tap name: amax} as Python floats."""
    amax: Dict[str, torch.Tensor] = {}
    _walker_for(folded)(folded, images, compute_dtype or torch.float32, quant=False,
                        amax=amax)
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


def _dc_entry_builder(s: Dict[str, float], device):
    """``dc_entry(name, sub, s_in_vec, requant_out)``: a folded DoubleConv ->
    its two int8 conv entries, conv1 over the per-Cin input scales
    ``s_in_vec``, conv2 over conv1's scale, requantised or dequantised."""

    def dc_entry(name, sub, s_in_vec, requant_out):
        c1 = _quantize_kernel(sub["conv1"]["w"], sub["conv1"]["b"], s_in_vec,
                              s[f"{name}.c1"], device)
        cin2 = sub["conv2"]["w"].shape[2]
        c2 = _quantize_kernel(sub["conv2"]["w"], sub["conv2"]["b"],
                              np.full(cin2, s[f"{name}.c1"], np.float32),
                              s[f"{name}.c2"] if requant_out else None, device)
        return {"conv1": c1, "conv2": c2}

    return dc_entry


def build_qparams(folded: dict, amax: Dict[str, float], device=None) -> dict:
    """An f32 :func:`folded_tree` of a UNet + calibration amaxes -> the int8
    qparams on ``device`` (the folded tensors' device when None).  JAX
    ``build_qparams``."""
    device = device if device is not None else folded["inc"]["conv1"]["w"].device
    s = {k: max(v, 1e-12) / 127.0 for k, v in amax.items()}
    dc_entry = _dc_entry_builder(s, device)

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


def build_qparams_pp(folded: dict, amax: Dict[str, float], device=None) -> dict:
    """An f32 :func:`folded_tree` of a UNet++ + calibration amaxes -> the int8
    qparams on ``device`` (the folded tensors' device when None).  JAX
    ``build_qparams_pp``: ``s_nodes[name]`` dequantises a requantised node
    for its float consumers, ``s_ups[name]`` quantises an upsample; each
    nested conv1 folds its skips' and its upsample's scales into its Cin
    slices."""
    device = device if device is not None else folded["x0_0"]["conv1"]["w"].device
    d, bilinear = _pp_depth(folded), "up0_1" not in folded
    s = {k: max(v, 1e-12) / 127.0 for k, v in amax.items()}
    w = [int(folded[f"x{i}_0"]["conv2"]["w"].shape[-1]) for i in range(d)]
    dc_entry = _dc_entry_builder(s, device)

    qp = {"s_x": _scalar(s["x"], device), "s_nodes": {}, "s_ups": {}}
    for head in ("outc", *(f"out{j}" for j in range(1, d))):
        if head in folded:
            qp[head] = _float_tensors(folded[head], device)
    prev_scale = s["x"]
    for i in range(d):
        name = f"x{i}_0"
        cin = folded[name]["conv1"]["w"].shape[2]
        rq = _pp_requant(d, i, 0)
        qp[name] = dc_entry(name, folded[name], np.full(cin, prev_scale, np.float32), rq)
        if rq:
            qp["s_nodes"][name] = _scalar(s[f"{name}.c2"], device)
        prev_scale = s[f"{name}.c2"]
    for j in range(1, d):
        for i in range(d - j):
            name, up_name = f"x{i}_{j}", f"up{i}_{j}"
            s_up = s[f"{up_name}.up"]
            up_c = w[i + 1] if bilinear else w[i]
            s_in = np.concatenate([np.full(w[i], s[f"x{i}_{k}.c2"], np.float32)
                                   for k in range(j)] + [np.full(up_c, s_up, np.float32)])
            rq = _pp_requant(d, i, j)
            qp[name] = dc_entry(name, folded[name], s_in, rq)
            if rq:
                qp["s_nodes"][name] = _scalar(s[f"{name}.c2"], device)
            qp["s_ups"][up_name] = _scalar(s_up, device)
            if not bilinear:
                qp[up_name] = _float_tensors(folded[up_name], device)
    return qp


def quantize_unet(folded: dict, calib_images: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Calibrate on ``calib_images`` and build, in one call (f32 folded tree
    of a UNet or a UNet++)."""
    build = build_qparams_pp if "x0_0" in folded else build_qparams
    return build(folded, calibrate_amax(folded, calib_images, compute_dtype))


@torch.inference_mode()
def apply_int8(qparams: dict, x: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 eval forward: (B, H, W[, C]) float images, H and W multiples
    of 16 -> (B, H, W, n_classes) f32 logits, through the UNet family's or
    UNet++'s walker as the qparams' keys say.  The float pieces run in
    ``compute_dtype`` (f32 when None)."""
    return _walker_for(qparams)(qparams, x, compute_dtype or torch.float32, quant=True,
                                amax={})
