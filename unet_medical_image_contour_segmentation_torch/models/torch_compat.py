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

Per-parameter tensors that are not weights (gradients, the optimizer's
``square_avg`` / ``momentum_buffer``) cross with the same transpositions
through :func:`params_tree_from_tensors` and :func:`tensors_from_params_tree`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["state_dict_from_jax", "params_from_state_dict", "load_pth",
           "params_tree_from_tensors", "tensors_from_params_tree"]


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


def params_from_state_dict(sd: Dict[str, Any]) -> Tuple[dict, dict, Optional[list]]:
    """A state_dict (numpy or torch values) -> JAX ``(params, state, mask_values)``."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in sd.items()}
    mask_values = sd.pop("mask_values", None)
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
    state_dict (the reference model's keys), ready for ``UNet.load_state_dict``."""
    out: Dict[str, np.ndarray] = {}
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
