"""Checkpoints in the JAX package's ``.npz`` format, plus reference ``.pth``.

The ``.npz`` layout is that of the JAX package's ``engine/checkpoint.py``:
one array per leaf of the ``params`` / ``bn_state`` / ``opt_state`` pytrees,
keyed by its path joined with ``//``, and a JSON ``__meta__`` entry (step,
mask_values, extra).  A checkpoint written by either package loads in the
other unchanged, for the UNet family, UNet++ and YOLOv8-seg; TransUNet's
holds its state_dict flat under its own names (``models/torch_compat.py``).
``.pth`` is the reference UNet's format, and TransUNet's (the published
state_dict): the reference ships no UNet++ or YOLO weights, and the JAX
package reads and writes no ``.pth`` of them, so the port refuses one too.

A save is two parts: a host snapshot (copies of the state_dict and of the
optimizer state, taken when the call is made) and the write of that
snapshot (the conversion to the JAX layout and ``np.savez``).
:func:`save_checkpoint` does both on the caller's thread;
:func:`save_checkpoint_async` takes the snapshot there and leaves the write
to a worker thread, as the JAX package's does, so a training loop does not
wait on the disk.
"""

from __future__ import annotations

import glob
import json
import os
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.torch_compat import (
    is_flat_torch,
    load_pth,
    params_from_state_dict,
    state_dict_from_jax,
)
from .optim import opt_state_tensors

__all__ = [
    "save_checkpoint",
    "save_checkpoint_async",
    "load_checkpoint",
    "load_weights",
    "latest_checkpoint",
]

_SEP = "//"


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    else:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _snapshot(path, model: nn.Module,
              optimizer: Optional[torch.optim.Optimizer]) -> Tuple[dict, Optional[dict]]:
    """Host copies of what a checkpoint of ``model`` holds, as they are now:
    its state_dict and, with ``optimizer``, the RMSprop state per parameter
    name.  Copies also of CPU tensors, whose ``.cpu()`` would share the
    storage that the next ``optimizer.step`` updates in place."""
    sd = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
    if str(path).endswith(".pth"):
        _require_reference_unet(sd, path)
        return sd, None
    return sd, None if optimizer is None else opt_state_tensors(model, optimizer)


def _write(path, sd: dict, opt: Optional[dict], step: int, mask_values,
           extra: Optional[dict]) -> None:
    """Write a snapshot of :func:`_snapshot` to ``path``."""
    if str(path).endswith(".pth"):
        if mask_values is not None:
            sd = dict(sd, mask_values=mask_values)
        torch.save(sd, path)
        return
    params, bn_state, _ = params_from_state_dict(sd)
    blobs: Dict[str, np.ndarray] = {}
    blobs.update({f"params{_SEP}{k}": v for k, v in _flatten(params).items()})
    blobs.update({f"bn_state{_SEP}{k}": v for k, v in _flatten(bn_state).items()})
    if opt is not None:
        # the parameters' entries replaced by their state, as opt_state_to_jax
        opt_state = {key: params_from_state_dict({**sd, **tensors})[0]
                     for key, tensors in opt.items()}
        blobs.update({f"opt_state{_SEP}{k}": v for k, v in _flatten(opt_state).items()})
    meta = {"step": int(step), "mask_values": mask_values, "extra": extra or {},
            "format": "umics-tpu-v1"}
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **blobs)


def save_checkpoint(path: str, model: nn.Module, step: int = 0,
                    mask_values=None, extra: Optional[dict] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write the model's weights as ``.npz``, or as a reference ``.pth``
    state_dict (with its ``mask_values`` entry) when the path says so.

    With ``optimizer`` (the RMSprop over ``model``'s parameters) the ``.npz``
    also holds its state as the JAX package's ``opt_state``, so a training
    run resumes from it in either package.  A ``.pth`` of a UNet++ or
    YOLOv8-seg raises ValueError (see the module docstring)."""
    _write(path, *_snapshot(path, model, optimizer), step, mask_values, extra)


def save_checkpoint_async(path: str, model: nn.Module, step: int = 0,
                          mask_values=None, extra: Optional[dict] = None,
                          optimizer: Optional[torch.optim.Optimizer] = None, *,
                          executor: Optional[Executor] = None) -> Future:
    """:func:`save_checkpoint` without the wait on the disk: the snapshot is
    taken on the caller's thread before this returns (so the model and the
    optimizer may step on at once), the write runs on a worker, and the
    returned Future holds its result or its exception.  The file equals the
    one :func:`save_checkpoint` would write at the call.

    ``executor``: where the write runs (a single-worker executor keeps a
    run's saves in order); by default a worker of its own, as the JAX
    package's ``save_checkpoint_async``."""
    snapshot = _snapshot(path, model, optimizer)
    worker = executor or ThreadPoolExecutor(max_workers=1, thread_name_prefix="umics-checkpoint")
    future = worker.submit(_write, path, *snapshot, step, mask_values, extra)
    if executor is None:
        worker.shutdown(wait=False)  # its thread ends after the write
    return future


def _require_reference_unet(sd: dict, path) -> None:
    if "inc.double_conv.0.weight" not in sd and not is_flat_torch(sd):
        raise ValueError(f"{path}: .pth holds the reference UNet family's or TransUNet's "
                         "state_dict only; keep UNet++ and YOLOv8-seg weights in .npz, as the "
                         "JAX package does")


def load_checkpoint(path: str) -> dict:
    """An ``.npz`` checkpoint -> dict(params, bn_state, opt_state, step,
    mask_values, extra), the pytrees as numpy arrays in the JAX layout."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, val in flat.items():
        group, rest = key.split(_SEP, 1)
        groups.setdefault(group, {})[rest] = val
    return {
        "params": _unflatten(groups.get("params", {})),
        "bn_state": _unflatten(groups.get("bn_state", {})),
        "opt_state": _unflatten(groups["opt_state"]) if "opt_state" in groups else None,
        "step": meta["step"],
        "mask_values": meta["mask_values"],
        "extra": meta.get("extra", {}),
    }


def load_weights(path: str, *, bilinear: bool = False, use_attention: bool = False
                 ) -> Tuple[Dict[str, torch.Tensor], Optional[list]]:
    """``.pth``/``.pt`` or ``.npz`` -> (the port's state_dict, mask_values).

    The flags are the JAX package's (``engine/checkpoint.py:load_weights``):
    a reference ``.pth`` is read as the weights of the UNet they name, so
    that ``get_model(..., bilinear=, use_attention=)`` takes the state_dict
    with a plain ``load_state_dict``: ``bilinear`` drops any ConvTranspose
    ``up{i}.up.*`` entry (JAX reads none), ``use_attention`` requires the
    ``up{i}.attention.conv1.weight`` entries (KeyError if one is missing).
    Without flags the state_dict comes back as the file holds it.  An
    ``.npz`` carries its own structure and loads as it is."""
    if str(path).endswith((".pth", ".pt")):
        sd, mask_values = load_pth(path)
        _require_reference_unet(sd, path)
        for i in range(1, 5):
            if bilinear:
                for k in [k for k in sd if k.startswith(f"up{i}.up.")]:
                    del sd[k]
            if use_attention and f"up{i}.attention.conv1.weight" not in sd:
                raise KeyError(f"{path}: no up{i}.attention.conv1.weight for use_attention")
        return sd, mask_values
    ck = load_checkpoint(path)
    return state_dict_from_jax(ck["params"], ck["bn_state"]), ck["mask_values"]


def latest_checkpoint(directory) -> Optional[str]:
    """The newest ``checkpoint_epoch*.npz`` / ``model_epoch*.npz`` in ``directory``."""
    candidates = sorted(glob.glob(os.path.join(str(directory), "checkpoint_epoch*.npz"))
                        + glob.glob(os.path.join(str(directory), "model_epoch*.npz")),
                        key=os.path.getmtime)
    return candidates[-1] if candidates else None
