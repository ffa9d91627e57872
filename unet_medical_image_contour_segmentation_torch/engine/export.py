"""Model export: ``torch.export`` programs with dynamic shapes.

The port's counterpart of the JAX package's ``engine/export.py``, whose
StableHLO bytes become ``torch.export.save``'s ``.pt2`` bytes.  The
reference exports ONNX opset 11 with dynamic batch, H and W
(the reference's ``export_model.py:30-46``; the port's ONNX writer is
``engine/onnx_export.py``):

* :func:`export_program`: the eval forward of a UNet, UNet++ or YOLOv8-seg
  with BN folded into the convs in the model's compute dtype (YOLO's BN
  live, as it serves; the program the ``Predictor`` serves), traced with a
  symbolic batch and H, W symbolic multiples of the model's ``hw_divisor``
  (16 for the UNets' four pooling levels, 2^(depth-1) for UNet++, 32 for
  YOLO's stride-32 backbone).  Each routed 3x3 conv is the operator
  ``umics::conv3x3_nhwc``, so the program launches the hand kernel on the
  card and runs its plain version on the CPU; so is each folded conv's
  bias and ReLU, ``umics::bias_relu_nhwc``.
* :func:`export_program_int8`: the int8 forward (``models/quantize.py:
  apply_int8``, the UNet family's, UNet++'s or YOLOv8-seg's) with its
  qparams baked in as buffers, a static H and W (one program per serving
  size, as JAX's) and a symbolic batch; every int8 3x3 stride-1 conv is the
  operator ``umics::conv3x3_int8`` (YOLO's SiLU epilogue included), and
  YOLO's int8 1x1 and stride-2 convs trace as ``torch._int_mm`` on the
  card.

The weights sit on the device the program was exported on, and the program
runs there.  :func:`load_exported` registers the port's operators before it
loads a program.
"""

from __future__ import annotations

import io
import logging
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

__all__ = ["export_program", "export_program_int8", "load_exported", "sanity_check",
           "logits_close"]

def _dims(dynamic_batch: bool, dynamic_hw: bool, hw_divisor: int) -> dict:
    """Symbolic dims: the batch, and H and W as multiples of ``hw_divisor``."""
    from torch.export import Dim

    spec = {}
    if dynamic_batch:
        spec[0] = Dim("b", min=1, max=4096)
    if dynamic_hw:
        spec[1] = hw_divisor * Dim("h", min=1, max=16384 // hw_divisor)
        spec[2] = hw_divisor * Dim("w", min=1, max=16384 // hw_divisor)
    return spec


def _save(program) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_program(model: nn.Module, *, example_hw: Tuple[int, int] = (512, 512),
                   dynamic_batch: bool = True, dynamic_hw: bool = True,
                   device: Optional[Union[str, torch.device]] = None) -> bytes:
    """The eval forward of ``model`` (BN folded where it folds, its compute
    dtype) as the bytes of a ``torch.export`` program: (B, H, W, n_channels)
    f32 -> (B, H, W, n_classes) f32, B symbolic with ``dynamic_batch``, H and
    W symbolic multiples of the model's ``hw_divisor`` with ``dynamic_hw``.
    ``device`` (default cuda, raising without a card) holds the weights and
    runs the program."""
    from ..device import resolve_device
    from ..kernels import bias_relu, conv3x3  # noqa: F401  (register the ops)
    from ..models.fold_bn import serving_copy

    device = resolve_device(device)
    net = serving_copy(model, model.compute_dtype).to(device)
    net.compute_dtype = model.compute_dtype
    x = torch.zeros((2, *example_hw, model.n_channels), dtype=torch.float32, device=device)
    dims = _dims(dynamic_batch, dynamic_hw, model.hw_divisor)
    with torch.no_grad():
        program = torch.export.export(net, (x,), dynamic_shapes={"x": dims})
    return _save(program)


class _Int8Forward(nn.Module):
    """``apply_int8`` with every qparams tensor a buffer (a flat name per
    path), so that the exported program carries them."""

    def __init__(self, qparams: dict, compute_dtype: Optional[torch.dtype]):
        super().__init__()
        self.compute_dtype = compute_dtype
        self._paths = []

        def walk(tree, path):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, (*path, k))
                else:
                    name = "__".join((*path, k))
                    self.register_buffer(name, v)
                    self._paths.append(((*path, k), name))

        walk(qparams, ())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from ..models.quantize import apply_int8

        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, name)
        return apply_int8(tree, x, self.compute_dtype)


def export_program_int8(model: nn.Module, qparams: dict, *,
                        example_hw: Tuple[int, int] = (512, 512),
                        dynamic_batch: bool = True) -> bytes:
    """The int8 forward (``apply_int8`` on ``qparams``, in ``model``'s compute
    dtype) as the bytes of a ``torch.export`` program at the static
    ``example_hw``, batch symbolic with ``dynamic_batch``, on the qparams'
    device.  The quantised weights and the requant scales are baked in: the
    program needs no calibration at serve time and loads as a float program
    does.  ``example_hw`` must be multiples of the model's ``hw_divisor``."""
    from ..kernels import conv3x3_int8  # noqa: F401  (registers umics::conv3x3_int8)

    if example_hw[0] % model.hw_divisor or example_hw[1] % model.hw_divisor:
        raise ValueError(f"example_hw {tuple(example_hw)} must be multiples of "
                         f"{model.hw_divisor}")
    net = _Int8Forward(qparams, model.compute_dtype).eval()
    x = torch.zeros((2, *example_hw, model.n_channels), dtype=torch.float32,
                    device=next(net.buffers()).device)
    with torch.no_grad():
        program = torch.export.export(
            net, (x,), dynamic_shapes={"x": _dims(dynamic_batch, False, model.hw_divisor)})
    return _save(program)


def load_exported(data: Union[bytes, str]):
    """``.pt2`` bytes (or a path to them) -> the ``torch.export``
    ExportedProgram, with the port's operators registered first."""
    from ..kernels import bias_relu, conv3x3, conv3x3_int8  # noqa: F401  (register the ops)

    return torch.export.load(io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data)


def sanity_check(data: bytes, model: nn.Module, hw=(512, 512),
                 device: Optional[Union[str, torch.device]] = None) -> bool:
    """Round trip: the loaded program against the live eval forward of
    ``model`` on one seeded image (:func:`logits_close`)."""
    from ..device import resolve_device

    device = resolve_device(device)
    program = load_exported(data).module()
    x = np.random.default_rng(0).random((1, *hw, model.n_channels), np.float32)
    xt = torch.from_numpy(x).to(device)
    with torch.no_grad():
        got = program(xt)
        was_training = model.training
        want = model.to(device).eval()(xt)
        model.train(was_training)
    return logits_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        "export sanity", class_axis=-1)


def logits_close(got, want, what: str, class_axis: int = -1) -> bool:
    """The JAX package's acceptance rule for logits whose consumer is an
    argmax: within a bf16-scale tolerance of the output range (rtol 1e-2,
    atol max(2e-3, 2% of max |want|)) and the argmax equal on >= 99.9% of
    pixels.  ``class_axis``: -1 for NHWC, 1 for NCHW (ONNX).  The agreement
    is logged either way."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    tol_ok = bool(np.allclose(got, want, rtol=1e-2, atol=max(2e-3, 0.02 * scale)))
    agree = float((got.argmax(class_axis) == want.argmax(class_axis)).mean())
    ok = tol_ok and agree >= 0.999
    report = log.info if ok else log.error
    report("%s %s: max diff %.4g (scale %.4g), argmax agreement %.5f",
           what, "passed" if ok else "FAILED", np.abs(got - want).max(), scale, agree)
    return ok
