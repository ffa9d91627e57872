"""Weights between the JAX package's pytrees and the port's state_dict.

The port's modules carry the reference model's state_dict keys, so a
reference ``.pth`` loads with ``load_state_dict``.  The JAX package keeps
NHWC pytrees; this module maps them both ways (the port's own copy of the
JAX package's ``models/torch_compat.py``, which it may not import):

    inc.double_conv.{0,3}.weight            <-> inc/conv{1,2}/w        (OIHW <-> HWIO)
    inc.double_conv.{1,4}.{weight,bias,     <-> inc/bn{1,2}/{scale,bias}
                           running_mean,var}    + state inc/bn{1,2}/{mean,var}
    down{i}.maxpool_conv.1.double_conv....  <-> down{i}/...
    up{i}.up.{weight,bias}                  <-> up{i}/upconv/{w,b}     ((in,out,kh,kw) <-> HWIO;
                                                                        absent in bilinear UNets)
    up{i}.attention.conv1.weight            <-> up{i}/att/conv/w       (OIHW <-> HWIO; unet_sa)
    up{i}.conv.double_conv....              <-> up{i}/conv/...
    outc.conv.{weight,bias}                 <-> outc/{w,b}

UNet++ and YOLOv8-seg have no reference ``.pth``; their modules are named
after the JAX pytree's paths, and one walk carries any of their trees by
the kind of each node (a node of the JAX tree, a module of the port):

    <n>.double_conv.{0,1,3,4}.*             <-> <n>/{conv1,bn1,conv2,bn2}   (DoubleConv, as above)
    <n>.{weight,bias,running_mean,var}      <-> <n>/{scale,bias} + state <n>/{mean,var}
                                                                    (BatchNorm2d: CBS's bn)
    <n>.weight                              <-> <n>/w   (a conv without bias: CBS's conv; OIHW)
    <n>.conv.{weight,bias}                  <-> <n>/{w,b}  (OutConv: a 1x1 conv with bias)
    <n>.{weight,bias}                       <-> <n>/{w,b}  (ConvTranspose2d, 2x2, (in,out,kh,kw))

so ``x{i}_{j}``, ``up{i}_{j}``, ``outc`` / ``out{j}`` (UNet++) and ``stem``,
``down{i}``, ``c2f{i}/m{k}/cv{1,2}/{conv,bn}``, ``sppf``, ``n4``, ``n3``,
``p_up{k}``, ``p_c{k}``, ``head`` (YOLO) cross without a per-model map.  In a
tree, a ``{w, b}`` node is an OutConv when its kernel is 1x1 and a
ConvTranspose otherwise; in a state_dict, the bias beside a ``conv`` holder
marks the OutConv.

Per-parameter tensors that are not weights (gradients, the optimizer's
``square_avg`` / ``momentum_buffer``) cross with the same transpositions
through :func:`params_tree_from_tensors` and :func:`tensors_from_params_tree`;
the int8 parameters of the JAX package's ``models/quantize.py:build_qparams``
and ``build_qparams_pp`` cross through :func:`qparams_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_jax", "params_from_state_dict", "load_pth",
           "params_tree_from_tensors", "tensors_from_params_tree", "qparams_from_jax"]


def _conv_w(t) -> np.ndarray:  # OIHW -> HWIO
    return np.asarray(t).transpose(2, 3, 1, 0)


def _convT_w(t) -> np.ndarray:  # (in, out, kh, kw) -> HWIO (I = in, O = out)
    return np.asarray(t).transpose(2, 3, 0, 1)


def _take_double_conv(sd: Dict[str, Any], key: str):
    params = {
        "conv1": {"w": _conv_w(sd[f"{key}.0.weight"])},
        "conv2": {"w": _conv_w(sd[f"{key}.3.weight"])},
    }
    state = {}
    for bn, idx in (("bn1", 1), ("bn2", 4)):
        params[bn] = {"scale": np.asarray(sd[f"{key}.{idx}.weight"]),
                      "bias": np.asarray(sd[f"{key}.{idx}.bias"])}
        state[bn] = {"mean": np.asarray(sd[f"{key}.{idx}.running_mean"]),
                     "var": np.asarray(sd[f"{key}.{idx}.running_var"])}
    return params, state


def _nested_set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_DOUBLE_CONV = {"0": "conv1", "1": "bn1", "3": "conv2", "4": "bn2"}
_BN_LEAF = {"weight": ("params", "scale"), "bias": ("params", "bias"),
            "running_mean": ("state", "mean"), "running_var": ("state", "var")}


def _params_from_nodes(sd: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """The walk of a UNet++ / YOLO state_dict (see the module docstring)."""
    params: dict = {}
    state: dict = {}
    for key, v in sd.items():
        mod, leaf = key.rsplit(".", 1)
        parts = mod.split(".")
        if leaf == "num_batches_tracked":
            continue
        if "double_conv" in parts:
            i = parts.index("double_conv")
            parts = parts[:i] + [_DOUBLE_CONV[parts[i + 1]]]
        if f"{mod}.running_mean" in sd:                       # BatchNorm2d
            group, name = _BN_LEAF[leaf]
            _nested_set(params if group == "params" else state, parts + [name], np.asarray(v))
        elif parts[-1] == "conv" and f"{mod}.bias" in sd:     # OutConv
            _nested_set(params, parts[:-1] + [{"weight": "w", "bias": "b"}[leaf]],
                        _conv_w(v) if leaf == "weight" else np.asarray(v))
        elif f"{mod}.bias" in sd:                             # ConvTranspose2d
            _nested_set(params, parts + [{"weight": "w", "bias": "b"}[leaf]],
                        _convT_w(v) if leaf == "weight" else np.asarray(v))
        else:                                                 # conv without bias
            _nested_set(params, parts + ["w"], _conv_w(v))
    return params, state


def _put_nodes(out: Dict[str, np.ndarray], prefix: str, params, state) -> None:
    """The walk of a UNet++ / YOLO params tree, the inverse of
    :func:`_params_from_nodes`."""
    for name, p in params.items():
        key, s = f"{prefix}{name}", (state or {}).get(name)
        if "conv1" in p:                                      # DoubleConv
            _put_double_conv(out, f"{key}.double_conv", p, s)
        elif "scale" in p:                                    # BatchNorm2d
            out[f"{key}.weight"] = np.asarray(p["scale"])
            out[f"{key}.bias"] = np.asarray(p["bias"])
            out[f"{key}.running_mean"] = np.asarray(s["mean"])
            out[f"{key}.running_var"] = np.asarray(s["var"])
            out[f"{key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
        elif "w" in p:
            w = np.asarray(p["w"])
            if "b" not in p:                                  # conv without bias
                out[f"{key}.weight"] = w.transpose(3, 2, 0, 1)
            elif w.shape[:2] == (1, 1):                       # OutConv
                out[f"{key}.conv.weight"] = w.transpose(3, 2, 0, 1)
                out[f"{key}.conv.bias"] = np.asarray(p["b"])
            else:                                             # ConvTranspose2d
                out[f"{key}.weight"] = w.transpose(2, 3, 0, 1)
                out[f"{key}.bias"] = np.asarray(p["b"])
        else:
            _put_nodes(out, f"{key}.", p, s)


def params_from_state_dict(sd: Dict[str, Any]) -> Tuple[dict, dict, Optional[list]]:
    """A state_dict (numpy or torch values) -> JAX ``(params, state, mask_values)``;
    the UNet family's by the reference map, UNet++'s and YOLO's by the walk."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    mask_values = sd.pop("mask_values", None)
    if "inc.double_conv.0.weight" not in sd:
        params, state = _params_from_nodes(sd)
        return params, state, mask_values
    params: dict = {}
    state: dict = {}
    params["inc"], state["inc"] = _take_double_conv(sd, "inc.double_conv")
    for i in range(1, 5):
        params[f"down{i}"], state[f"down{i}"] = _take_double_conv(
            sd, f"down{i}.maxpool_conv.1.double_conv")
    for i in range(1, 5):
        p: dict = {}
        if f"up{i}.up.weight" in sd:
            p["upconv"] = {"w": _convT_w(sd[f"up{i}.up.weight"])}
            if f"up{i}.up.bias" in sd:
                p["upconv"]["b"] = np.asarray(sd[f"up{i}.up.bias"])
        p["conv"], conv_s = _take_double_conv(sd, f"up{i}.conv.double_conv")
        if f"up{i}.attention.conv1.weight" in sd:
            p["att"] = {"conv": {"w": _conv_w(sd[f"up{i}.attention.conv1.weight"])}}
        params[f"up{i}"] = p
        state[f"up{i}"] = {"conv": conv_s}
    params["outc"] = {"w": _conv_w(sd["outc.conv.weight"]), "b": np.asarray(sd["outc.conv.bias"])}
    return params, state, mask_values


def _put_double_conv(out: Dict[str, np.ndarray], key: str, params, state) -> None:
    out[f"{key}.0.weight"] = np.asarray(params["conv1"]["w"]).transpose(3, 2, 0, 1)
    out[f"{key}.3.weight"] = np.asarray(params["conv2"]["w"]).transpose(3, 2, 0, 1)
    for bn, idx in (("bn1", 1), ("bn2", 4)):
        out[f"{key}.{idx}.weight"] = np.asarray(params[bn]["scale"])
        out[f"{key}.{idx}.bias"] = np.asarray(params[bn]["bias"])
        out[f"{key}.{idx}.running_mean"] = np.asarray(state[bn]["mean"])
        out[f"{key}.{idx}.running_var"] = np.asarray(state[bn]["var"])
        out[f"{key}.{idx}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def state_dict_from_jax(params, bn_state) -> Dict[str, torch.Tensor]:
    """The JAX package's ``(params, bn_state)`` numpy pytrees -> the port's
    state_dict, ready for ``load_state_dict``: the reference model's keys for
    the UNet family, the walk's for UNet++ and YOLO."""
    out: Dict[str, np.ndarray] = {}
    if "inc" not in params:
        _put_nodes(out, "", params, bn_state)
        return {k: torch.tensor(v) for k, v in out.items()}
    _put_double_conv(out, "inc.double_conv", params["inc"], bn_state["inc"])
    for i in range(1, 5):
        _put_double_conv(out, f"down{i}.maxpool_conv.1.double_conv",
                         params[f"down{i}"], bn_state[f"down{i}"])
    for i in range(1, 5):
        p = params[f"up{i}"]
        if "upconv" in p:
            out[f"up{i}.up.weight"] = np.asarray(p["upconv"]["w"]).transpose(2, 3, 0, 1)
            if "b" in p["upconv"]:
                out[f"up{i}.up.bias"] = np.asarray(p["upconv"]["b"])
        if "att" in p:
            out[f"up{i}.attention.conv1.weight"] = np.asarray(
                p["att"]["conv"]["w"]).transpose(3, 2, 0, 1)
        _put_double_conv(out, f"up{i}.conv.double_conv", p["conv"],
                         bn_state[f"up{i}"]["conv"])
    out["outc.conv.weight"] = np.asarray(params["outc"]["w"]).transpose(3, 2, 0, 1)
    out["outc.conv.bias"] = np.asarray(params["outc"]["b"])
    return {k: torch.tensor(v) for k, v in out.items()}


def params_tree_from_tensors(model: nn.Module, tensors: Dict[str, Any]) -> dict:
    """Tensors keyed by the model's parameter names, each shaped like its
    parameter -> a numpy pytree in the JAX ``params`` layout (transposed as
    the weights are).  The model's buffers fill the rest of the state_dict."""
    sd = dict(model.state_dict())
    sd.update(tensors)
    params, _, _ = params_from_state_dict(sd)
    return params


def tensors_from_params_tree(model: nn.Module, tree) -> Dict[str, torch.Tensor]:
    """The inverse: a pytree in the JAX ``params`` layout -> CPU tensors keyed
    by the model's parameter names, shaped like the parameters."""
    _, bn_state, _ = params_from_state_dict(model.state_dict())
    sd = state_dict_from_jax(tree, bn_state)
    return {name: sd[name] for name, _ in model.named_parameters()}


def qparams_from_jax(tree, device="cpu") -> dict:
    """The JAX package's ``build_qparams``, ``build_qparams_pp`` or
    ``build_qparams_yolo`` output (numpy or jax arrays) -> the port's qparams
    on ``device``: the same keys, each int8 conv entry ``{w, mul, badd[,
    inv_s]}`` with its HWIO weight in the form the port's int8 conv reads
    (``models/quantize.py:int8_conv_weight``: packed for the kernel, or a
    matrix for YOLO's 1x1 and stride-2 convs), every other array (scales,
    float convs, ConvT, attention, heads) an f32 tensor.  Both packages then
    serve from identical int8 weights and scales."""
    from .quantize import _YOLO_STRIDE2, int8_conv_weight

    def convert(t, stride=1):
        if isinstance(t, dict):
            if {"w", "mul", "badd"} <= set(t):
                w = torch.from_numpy(np.array(t["w"], np.int8))
                return {"w": int8_conv_weight(w, stride).to(device),
                        **{k: convert(v) for k, v in t.items() if k != "w"}}
            return {k: convert(v, 2 if k in _YOLO_STRIDE2 and "stem" in t else 1)
                    for k, v in t.items()}
        return torch.tensor(np.asarray(t, np.float32), device=device)

    return convert(tree)


def load_pth(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[list]]:
    """A reference ``.pth``/``.pt`` -> (state_dict, mask_values).

    Takes the three kinds a reference deployment may hold: a raw state_dict
    (possibly wrapped as ``{'state_dict': ...}``), a whole pickled
    ``nn.Module``, or a TorchScript archive.
    """
    import zipfile

    # TorchScript archives hold constants.pkl; eager torch.save zips data.pkl
    is_jit = False
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            is_jit = any(n.endswith("constants.pkl") for n in zf.namelist())
    if is_jit:
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
    else:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(obj, dict):
            inner = obj.get("state_dict")
            sd = dict(inner) if isinstance(inner, dict) else dict(obj)
        elif hasattr(obj, "state_dict"):
            sd = dict(obj.state_dict())
        else:
            raise ValueError(f"{path}: torch.load produced {type(obj).__name__}, expected a "
                             "state_dict, a checkpoint dict, a pickled module, or a "
                             "TorchScript archive")
    mask_values = sd.pop("mask_values", None)
    return {k: torch.as_tensor(v) for k, v in sd.items()}, mask_values
