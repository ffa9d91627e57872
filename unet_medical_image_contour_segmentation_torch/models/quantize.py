"""Post-training int8 quantisation of the eval forward of the UNet family,
UNet++ and YOLOv8-seg.

The port of the JAX package's ``models/quantize.py`` for the UNet family
(unet, unet_t, unet_s, unet_sa, bilinear or ConvTranspose ups), UNet++
(unet_pp_s, unet_pp; bilinear, deep supervision) and YOLOv8-seg, on NHWC
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

YOLOv8-seg (JAX ``_forward_yolo``): SiLU does not commute with a scale, so
an int8 CBS conv's epilogue dequantises at true scale (``mul = s_w``,
``badd = b``), applies SiLU in f32, and either casts to the compute dtype
or requantises with its own ``inv_s`` onto the signed grid [-127, 127].
The entry's format decides per conv: ``{w, mul, badd[, inv_s]}`` runs
int8, a folded ``{w, b}`` runs in float, so one walker serves both
placements of :func:`build_qparams_yolo`: ``scope="proto"`` (the default:
the proto head's three 3x3 convs int8, the backbone and neck the folded
float tree) and ``"full"`` (every CBS int8; the bottlenecks' residual adds
dequantise both sides, add in f32 and requantise to the sum's scale; SPPF
pools int8; the neck upsamples int8 by nearest neighbour and concatenates
parts of different scales, each folded into its Cin slice of the weight).
Its 3x3 stride-1 convs run on the int8 kernel with ``act="silu"``; the
stride-2 stem and downsamples and the 1x1 convs, which JAX leaves to XLA
(``ops/wide.py:conv_wide_int8`` with stride 2, ``conv1x1_wide_int8``),
are int8 matrix products (:func:`int8_matmul_sums`: ``torch._int_mm`` on
the card, an exact float64 product on the CPU) with the same epilogue as
plain torch ops.

The qparams are a plain nested dict with the JAX tree's keys: ``s_x``,
``inc/conv1/{w, mul, badd}``, ..., ``up{i}/{conv, s_up, upconv, att,
s_skip}``, ``outc`` for the UNet family; ``s_x``, ``s_nodes``, ``s_ups``,
``x{i}_{j}/conv{1,2}``, ``up{i}_{j}``, ``outc`` or ``out{j}`` for UNet++;
``[s_x], stem, down{i}, c2f{i}/{cv1, cv2, m{k}/{cv1, cv2[, res_s,
add_inv_s]}}, sppf, n4, n3, p_up{k}, s_pc{k}, p_c{k}, head`` for YOLOv8-seg.
The walker follows the tree's keys (JAX ``_walker_for``), and
:func:`apply_int8` returns f32 NHWC logits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.conv3x3_int8 import conv3x3_int8, epilogue, pack_weight
from ..ops.nn import conv2d, conv_transpose2d, max_pool2d
from ..ops.resize import upsample_x2_align_corners
from .blocks import attention_gate
from .yolov8_seg import maxpool5_same, silu_f32, upsample_nearest2

__all__ = ["folded_tree", "calibrate_amax", "build_qparams", "build_qparams_pp",
           "build_qparams_yolo", "build_for", "quantize_unet", "apply_int8",
           "int8_matmul_sums", "int8_conv_weight"]

_ENCODER = ("inc", "down1", "down2", "down3", "down4")
# YOLOv8-seg's stride-2 CBS convs (the stem and the four downsamples)
_YOLO_STRIDE2 = ("stem", "down0", "down1", "down2", "down3")


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
    outc or out{j}: {w, b}}`` for UNet++; for a YOLOv8-seg folded by
    ``fold_bn.py:fold_yolo``, JAX ``fold_yolo_params``'s tree: ``{stem,
    down{i}: {w, b}, c2f{i}, n4, n3: {cv1, cv2, m{k}: {cv1, cv2}}, sppf:
    {cv1, cv2}, p_up{k}: {w, b}, p_c{k}: {w, b}, head: {w, b}}``."""
    dc = _folded_dc
    if hasattr(net, "stem"):  # YOLOv8-seg
        return _folded_yolo(net)
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


def _folded_yolo(net: nn.Module) -> dict:
    def cbs(m):
        return {"w": m.w, "b": m.b}

    def c2f(m):
        return {"cv1": cbs(m.cv1), "cv2": cbs(m.cv2),
                **{f"m{k}": {"cv1": cbs(getattr(m, f"m{k}").cv1),
                             "cv2": cbs(getattr(m, f"m{k}").cv2)} for k in range(m.n)}}

    tree = {"stem": cbs(net.stem)}
    for i in range(4):
        tree[f"down{i}"] = cbs(getattr(net, f"down{i}"))
        tree[f"c2f{i}"] = c2f(getattr(net, f"c2f{i}"))
    tree["sppf"] = {"cv1": cbs(net.sppf.cv1), "cv2": cbs(net.sppf.cv2)}
    tree["n4"], tree["n3"] = c2f(net.n4), c2f(net.n3)
    for k in (1, 2, 3):
        up = getattr(net, f"p_up{k}")
        tree[f"p_up{k}"] = {"w": up.weight.permute(2, 3, 0, 1), "b": up.bias}
        tree[f"p_c{k}"] = cbs(getattr(net, f"p_c{k}"))
    tree["head"] = _head(net.head)
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


# -- YOLOv8-seg ---------------------------------------------------------------


def int8_conv_weight(w_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """An int8 HWIO weight in the form its int8 conv reads: a 3x3 stride-1
    conv's :func:`pack_weight` for the kernel, else (a 1x1 conv, or a 3x3
    stride-2 one) the (Cout_p, K_p) matrix of :func:`int8_matmul_sums`,
    element [co, (u * k + v) * Cin + ci], zeros past Cout and K (both
    padded to multiples of 8, ``torch._int_mm``'s rule)."""
    kh, kw, cin, cout = w_q.shape
    if kh == 3 and stride == 1:
        return pack_weight(w_q)
    k = kh * kw * cin
    m = torch.zeros((_round8(cout), _round8(k)), dtype=torch.int8, device=w_q.device)
    m[:cout, :k] = w_q.reshape(k, cout).T
    return m


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def int8_matmul_sums(a: torch.Tensor, wm: torch.Tensor) -> torch.Tensor:
    """int8 (M, K_p) rows times the (Cout_p, K_p) matrix of
    :func:`int8_conv_weight`, transposed -> int32 (M, Cout_p), exact: on
    the card ``torch._int_mm`` (cuBLASLt's int8 GEMM; M padded past 16,
    its rule), on the CPU a float64 product (|sum| < 2^53)."""
    if a.is_cuda:
        m = a.shape[0]
        if m <= 16:
            a = F.pad(a, (0, 0, 0, 17 - m))
        return torch._int_mm(a, wm.t())[:m]
    return (a.double() @ wm.double().T).to(torch.int32)


def _int8_conv_sums(x: torch.Tensor, wm: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """The int32 sums of a k x k conv (k = 1, or 3 with pad 1) of int8 NHWC x
    at ``stride`` through :func:`int8_matmul_sums` on the im2col rows
    (JAX ``conv1x1_wide_int8`` / ``conv_wide_int8`` with stride 2)."""
    b, h, w, cin = x.shape
    if k == 1:
        ho, wo, rows = h, w, x
    else:
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        rows = torch.cat([xp[:, u:u + stride * (ho - 1) + 1:stride,
                             v:v + stride * (wo - 1) + 1:stride] for u in range(3)
                          for v in range(3)], dim=-1)
    kp = wm.shape[1]
    rows = rows.reshape(b * ho * wo, -1)
    if rows.shape[1] != kp:
        rows = F.pad(rows, (0, kp - rows.shape[1]))
    return int8_matmul_sums(rows.contiguous(), wm).reshape(b, ho, wo, -1)


def _requant_signed(yf: torch.Tensor, inv_s: torch.Tensor) -> torch.Tensor:
    """f32 -> int8 on the signed grid [-127, 127] (JAX ``_requant_signed``)."""
    return torch.clamp(torch.round(yf * inv_s), -127, 127).to(torch.int8)


def _requant_add(t: torch.Tensor, yf: torch.Tensor, res_s: torch.Tensor,
                 add_inv_s: torch.Tensor) -> torch.Tensor:
    """A bottleneck's residual ``t + yf`` on the int8 path: int8 ``t``
    dequantised with ``res_s``, plus ``yf`` (cv2's dequantised output), in
    f32 with two roundings, requantised to the sum's scale."""
    return _requant_signed(t.float() * res_s + yf.float(), add_inv_s)


def _maxpool5_same_int8(x: torch.Tensor) -> torch.Tensor:
    """SPPF's 5x5 stride-1 SAME max pool of int8 NHWC x, staying int8 (JAX
    ``_maxpool5_same_int8``, padding -128).  PyTorch's max pool takes no
    int8, so it pools the values as float16, where -127..127 are exact;
    its -inf padding picks what -128 does, since every window holds a
    pixel of the image."""
    y = F.max_pool2d(x.to(torch.float16).permute(0, 3, 1, 2), 5, stride=1, padding=2)
    return y.permute(0, 2, 3, 1).to(torch.int8)


def _c2f_depth(entry: dict) -> int:
    return sum(1 for k in entry if k.startswith("m"))


def _forward_yolo(p: dict, x: torch.Tensor, cd: torch.dtype, *, quant: bool,
                  amax: Dict[str, torch.Tensor]) -> torch.Tensor:
    """YOLOv8-seg's walker (JAX ``_forward_yolo`` on NHWC): calibration
    (quant=False, p = a folded tree, fills ``amax`` with JAX's tap names)
    and execution (quant=True, p = :func:`build_qparams_yolo`'s qparams,
    each conv int8 or float as its entry's format says)."""
    if x.dim() == 3:
        x = x.unsqueeze(-1)

    def cbs(name, entry, t, stride=1, *, requant):
        if isinstance(t, list):
            t = torch.cat(t, dim=-1)
        if quant and "mul" in entry:
            out_dtype = torch.int8 if requant else cd
            inv_s = entry["inv_s"] if requant else None
            w = entry["w"]
            if w.dim() == 6:  # a packed 3x3 stride-1 weight: the int8 kernel
                return conv3x3_int8(t.contiguous(), w, entry["mul"], entry["badd"], out_dtype,
                                    act="silu", inv_s=inv_s)
            # a matrix: the stride-2 convs are 3x3, the stride-1 ones 1x1
            acc = _int8_conv_sums(t, w, 3 if stride == 2 else 1, stride)
            acc = acc[..., :entry["mul"].shape[0]]
            return epilogue(acc, entry["mul"], entry["badd"], out_dtype, "silu", inv_s)
        w = entry["w"]
        y = silu_f32(conv2d(t, w, entry["b"], stride=stride, padding=w.shape[0] // 2,
                            compute_dtype=cd))
        if not quant:
            amax[name] = _amax(y)
        return y

    def bottleneck(base, k, entry, t):
        y = cbs(f"{base}.m{k}.cv1", entry["cv1"], t, requant=True)
        yf = cbs(f"{base}.m{k}.cv2", entry["cv2"], y, requant=False)
        if quant and "res_s" in entry:
            return _requant_add(t, yf, entry["res_s"], entry["add_inv_s"])
        out = t + yf.to(t.dtype)
        if not quant:
            amax[f"{base}.m{k}.add"] = _amax(out)
        return out

    def c2f(base, entry, t, *, requant_out=True):
        y = cbs(f"{base}.cv1", entry["cv1"], t, requant=True)
        c = y.shape[-1] // 2
        parts = [y[..., :c], y[..., c:]]
        for k in range(_c2f_depth(entry)):
            parts.append(bottleneck(base, k, entry[f"m{k}"], parts[-1]))
        return cbs(f"{base}.cv2", entry["cv2"], parts, requant=requant_out)

    # -- backbone
    if quant and "s_x" in p:
        x = _quant_sym(x, p["s_x"])
    elif not quant:
        amax["x"] = _amax(x)
    cur = cbs("stem", p["stem"], x, 2, requant=True)
    feats = []
    for i in range(4):
        cur = cbs(f"d{i}", p[f"down{i}"], cur, 2, requant=True)
        cur = c2f(f"c2f{i}", p[f"c2f{i}"], cur)
        feats.append(cur)

    # -- SPPF
    y = cbs("sppf.cv1", p["sppf"]["cv1"], cur, requant=True)
    pool = _maxpool5_same_int8 if y.dtype == torch.int8 else maxpool5_same
    p1 = pool(y)
    p2 = pool(p1)
    y = cbs("sppf.cv2", p["sppf"]["cv2"], [y, p1, p2, pool(p2)], requant=True)

    # -- FPN neck (nearest x2 is scale-preserving: int8 stays int8)
    p4 = c2f("n4", p["n4"], [upsample_nearest2(y), feats[2]])
    t = c2f("n3", p["n3"], [upsample_nearest2(p4), feats[1]], requant_out=False)

    # -- proto head: the ConvT ups float; each p_c conv re-enters int8
    for k in (1, 2, 3):
        up = p[f"p_up{k}"]
        t = conv_transpose2d(t.to(cd), up["w"], up.get("b"), stride=2, compute_dtype=cd)
        if quant and f"s_pc{k}" in p:
            t = _quant_sym(t, p[f"s_pc{k}"])
        elif not quant:
            amax[f"p_c{k}.in"] = _amax(t)
        t = cbs(f"p_c{k}", p[f"p_c{k}"], t, requant=False)
    return conv2d(t.to(cd), p["head"]["w"], p["head"].get("b"), compute_dtype=cd).float()


def _walker_for(tree: dict):
    if "stem" in tree:
        return _forward_yolo
    return _forward_pp if "x0_0" in tree else _forward


@torch.inference_mode()
def calibrate_amax(folded: dict, images: torch.Tensor,
                   compute_dtype: Optional[torch.dtype] = None) -> Dict[str, float]:
    """The float eval forward of ``folded`` (a :func:`folded_tree`) with amax
    taps, in ``compute_dtype`` (f32 when None), on ``images`` (B, H, W[, C])
    float with H, W multiples of the model's ``hw_divisor`` -> {tap name:
    amax} as Python floats."""
    amax: Dict[str, torch.Tensor] = {}
    _walker_for(folded)(folded, images, compute_dtype or torch.float32, quant=False,
                        amax=amax)
    values = torch.stack(list(amax.values())).tolist()
    return dict(zip(amax, values))


def _numpy(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _quantize_weight(w, s_in):
    """HWIO kernel with the per-Cin input scales ``s_in`` folded in -> (int8
    HWIO weight, per-Cout f32 scale s_w), in numpy f32, line for line the
    JAX package's ``_quantize_kernel`` / ``build_qparams_yolo``'s ``qcbs``."""
    w_eff = _numpy(w).astype(np.float32) * np.asarray(s_in, np.float32)[None, None, :, None]
    s_w = np.maximum(np.abs(w_eff).max(axis=(0, 1, 2)) / 127.0, 1e-12)
    return np.clip(np.round(w_eff / s_w), -127, 127).astype(np.int8), s_w


def _quantize_kernel(w, b, s_in, s_out, device) -> dict:
    """HWIO kernel + bias -> {w: packed int8, mul, badd} with the input scales
    folded in; ``s_out`` the output scale (requant) or None (dequant)."""
    b = _numpy(b).astype(np.float32)
    w_q, s_w = _quantize_weight(w, s_in)
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


def build_qparams_yolo(folded: dict, amax: Dict[str, float], scope: str = "proto",
                       device=None) -> dict:
    """An f32 :func:`folded_tree` of a YOLOv8-seg + calibration amaxes -> the
    int8 qparams on ``device`` (the folded tensors' device when None).  JAX
    ``build_qparams_yolo``: each int8 CBS entry ``{w, mul, badd[, inv_s]}``
    holds the true dequant (``mul = s_w``, ``badd = b``) and, where its
    output requantises, ``inv_s = 1 / s_out``; each bottleneck ``res_s``
    (its chain input's scale) and ``add_inv_s`` (1 / the sum's); the parts
    of a concatenated input (C2f's cv2, the neck's cv1, SPPF's cv2) fold
    their own scales into their Cin slices.  ``scope``: "proto" (only
    ``p_c1..3`` int8; the backbone and neck stay the folded float tree) or
    "full" (every CBS int8)."""
    if scope not in ("proto", "full"):
        raise ValueError(f"scope must be 'proto' or 'full', not {scope!r}")
    device = device if device is not None else folded["stem"]["w"].device
    s = {k: max(v, 1e-12) / 127.0 for k, v in amax.items()}

    def qcbs(entry, s_in_vec, s_out, stride=1):
        w_q, s_w = _quantize_weight(entry["w"], s_in_vec)
        out = {"w": int8_conv_weight(torch.from_numpy(w_q), stride).to(device),
               "mul": torch.from_numpy(np.asarray(s_w, np.float32)).to(device),
               "badd": torch.from_numpy(_numpy(entry["b"]).astype(np.float32)).to(device)}
        if s_out is not None:
            out["inv_s"] = _scalar(1.0 / s_out, device)
        return out

    def const(entry, sv):
        return np.full(entry["w"].shape[2], sv, np.float32)

    def qc2f(base, entry, s_in_vec, requant_out):
        out = {"cv1": qcbs(entry["cv1"], s_in_vec, s[f"{base}.cv1"])}
        c = entry["cv1"]["w"].shape[3] // 2
        chain_s = s[f"{base}.cv1"]
        n = _c2f_depth(entry)
        for k in range(n):
            m, mk = entry[f"m{k}"], f"{base}.m{k}"
            out[f"m{k}"] = {
                "cv1": qcbs(m["cv1"], const(m["cv1"], chain_s), s[f"{mk}.cv1"]),
                "cv2": qcbs(m["cv2"], const(m["cv2"], s[f"{mk}.cv1"]), None),
                "res_s": _scalar(chain_s, device),
                "add_inv_s": _scalar(1.0 / s[f"{mk}.add"], device),
            }
            chain_s = s[f"{mk}.add"]
        parts_s = [s[f"{base}.cv1"]] * 2 + [s[f"{base}.m{k}.add"] for k in range(n)]
        s_in2 = np.concatenate([np.full(c, ps, np.float32) for ps in parts_s])
        out["cv2"] = qcbs(entry["cv2"], s_in2,
                          s[f"{base}.cv2"] if requant_out else None)
        return out

    fp = folded
    if scope == "full":
        qp = {"s_x": _scalar(s["x"], device),
              "stem": qcbs(fp["stem"], const(fp["stem"], s["x"]), s["stem"], 2)}
        prev = "stem"
        for i in range(4):
            qp[f"down{i}"] = qcbs(fp[f"down{i}"], const(fp[f"down{i}"], s[prev]),
                                  s[f"d{i}"], 2)
            qp[f"c2f{i}"] = qc2f(f"c2f{i}", fp[f"c2f{i}"], const(fp[f"c2f{i}"]["cv1"],
                                                                  s[f"d{i}"]), True)
            prev = f"c2f{i}.cv2"
        qp["sppf"] = {
            "cv1": qcbs(fp["sppf"]["cv1"], const(fp["sppf"]["cv1"], s["c2f3.cv2"]),
                        s["sppf.cv1"]),
            "cv2": qcbs(fp["sppf"]["cv2"], const(fp["sppf"]["cv2"], s["sppf.cv1"]),
                        s["sppf.cv2"]),
        }
        c5 = fp["sppf"]["cv2"]["w"].shape[3]
        c4 = fp["c2f2"]["cv2"]["w"].shape[3]
        c3 = fp["c2f1"]["cv2"]["w"].shape[3]
        qp["n4"] = qc2f("n4", fp["n4"], np.concatenate([
            np.full(c5, s["sppf.cv2"], np.float32), np.full(c4, s["c2f2.cv2"], np.float32)]),
            True)
        qp["n3"] = qc2f("n3", fp["n3"], np.concatenate([
            np.full(c4, s["n4.cv2"], np.float32), np.full(c3, s["c2f1.cv2"], np.float32)]),
            False)
    else:  # "proto": the backbone and neck stay the folded float tree
        qp = {k: _float_tensors(fp[k], device)
              for k in ["stem", "sppf", "n4", "n3", *(f"down{i}" for i in range(4)),
                        *(f"c2f{i}" for i in range(4))]}
    for k in (1, 2, 3):
        qp[f"p_up{k}"] = _float_tensors(fp[f"p_up{k}"], device)
        qp[f"s_pc{k}"] = _scalar(s[f"p_c{k}.in"], device)
        qp[f"p_c{k}"] = qcbs(fp[f"p_c{k}"], const(fp[f"p_c{k}"], s[f"p_c{k}.in"]),
                             None)
    qp["head"] = _float_tensors(fp["head"], device)
    return qp


def build_for(folded: dict):
    """The qparams function of a :func:`folded_tree`'s topology: :func:`build_qparams_pp`
    (UNet++), :func:`build_qparams_yolo` (YOLOv8-seg, its default scope) or
    :func:`build_qparams` (the UNet family); JAX ``quantize_unet``'s
    dispatch."""
    if "x0_0" in folded:
        return build_qparams_pp
    return build_qparams_yolo if "stem" in folded else build_qparams


def quantize_unet(folded: dict, calib_images: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> dict:
    """Calibrate on ``calib_images`` and build, in one call (an f32 folded
    tree of a UNet, a UNet++ or a YOLOv8-seg)."""
    return build_for(folded)(folded, calibrate_amax(folded, calib_images, compute_dtype))


@torch.inference_mode()
def apply_int8(qparams: dict, x: torch.Tensor,
               compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The int8 eval forward: (B, H, W[, C]) float images, H and W multiples
    of the model's ``hw_divisor`` -> (B, H, W, n_classes) f32 logits,
    through the UNet family's, UNet++'s or YOLOv8-seg's walker as the
    qparams' keys say.  The float pieces run in ``compute_dtype`` (f32 when
    None)."""
    return _walker_for(qparams)(qparams, x, compute_dtype or torch.float32, quant=True,
                                amax={})
