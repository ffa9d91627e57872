"""Rank bodies for the port's spatial-parallel tests (tests/test_torch_spatial.py).

Like ``tests/torch_dp_ranks.py`` (whose ``run_ranks`` spawns them), this
module imports torch and the port but no JAX.  Each rank builds the
(data, spatial) layout, runs every case it is given on its block of the
global inputs, and returns the results for the test process to compare.
The halo cases' data, whole-image forms and checks live here too, for the
card's run of them (``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from unet_medical_image_contour_segmentation_torch import exact_f32
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.models.torch_compat import state_dict_from_jax
from unet_medical_image_contour_segmentation_torch.models.unet import UNet
from unet_medical_image_contour_segmentation_torch.models.unet_nested import UNetPlusPlus
from unet_medical_image_contour_segmentation_torch.models.yolov8_seg import (
    YOLOv8Seg,
    maxpool5_same,
)
from unet_medical_image_contour_segmentation_torch.ops.halo import halo_exchange
from unet_medical_image_contour_segmentation_torch.ops.nn import conv2d
from unet_medical_image_contour_segmentation_torch.ops.resize import upsample_x2_align_corners
from unet_medical_image_contour_segmentation_torch.parallel import (
    make_dp_spatial_mesh,
    make_spatial_forward,
    make_spatial_train_step,
    replicate,
    shard_batch,
)
from unet_medical_image_contour_segmentation_torch.parallel.spatial import band_rows

# the reference lr: RMSprop's first step moves each parameter by ~10 * lr
# whatever |g|, so a gradient whose sign rounding flips moves it by 2e-4 at most
LR = 1e-5
ARCHS = {"unet": UNet, "unet_pp": UNetPlusPlus, "yolo": YOLOv8Seg}
# the pool case's input is x - POOL_SHIFT: negative at the image's first and
# last rows (N(0, 1) draws), where a zero fill would win the max
POOL_SHIFT = 4.0
SP = 2


def build(spec: dict) -> torch.nn.Module:
    """The model of a case: ``spec["arch"]`` with ``spec["kw"]``, loaded
    with the case's JAX-layout weights."""
    model = ARCHS[spec["arch"]](**spec["kw"])
    model.load_state_dict(state_dict_from_jax(spec["params"], spec["bn_state"]))
    return model


def step_case(mesh, spec: dict) -> dict:
    """One row-sharded step on this rank's block of ``spec["batch"]``:
    metrics, the averaged and clipped gradients, parameters and buffers."""
    model = build(spec)
    step = make_spatial_train_step(model, TL.LossConfig(**spec.get("loss", {})),
                                   RMSpropConfig(learning_rate=LR), mesh)
    replicate(model, step.optimizer, mesh.group)
    metrics = step(shard_batch({k: torch.from_numpy(v) for k, v in spec["batch"].items()},
                               mesh), LR)
    return {"metrics": metrics,
            "grads": {k: p.grad for k, p in model.named_parameters()},
            "state": {k: v.detach() for k, v in model.state_dict().items()}}


def forward_case(mesh, spec: dict) -> torch.Tensor:
    """The eval logits of the whole ``spec["image"]`` batch, every rank
    computing its block."""
    return make_spatial_forward(build(spec), mesh)(torch.from_numpy(spec["image"]))


def _halo_ops(shard) -> dict:
    """name -> op(x, w) of the halo cases, on ``shard``'s band (None: the
    whole images)."""
    return {
        "halo1": lambda x, w: halo_exchange(x, shard, 1),
        "halo3": lambda x, w: halo_exchange(x, shard, 3),
        "conv3": lambda x, w: conv2d(x, w, padding=1, shard=shard),
        "conv7": lambda x, w: conv2d(x[..., :2], w, padding=3, shard=shard),
        "upsample": lambda x, w: upsample_x2_align_corners(x, shard),
        "conv_s2": lambda x, w: conv2d(x, w, stride=2, padding=1, shard=shard),
        "maxpool5": lambda x, w: maxpool5_same(x - POOL_SHIFT, shard),
    }


def halo_data(device: str = "cpu") -> dict:
    """Seeded (2, 16, 12, 8) images, weights and one output gradient per
    band and op of :func:`halo_case`, for ``SP`` bands on ``device``."""
    rng = np.random.default_rng(21)
    x = rng.normal(0, 1, (2, 16, 12, 8)).astype(np.float32)
    h = x.shape[1] // SP
    out = {"halo1": (2, h + 2, 12, 8), "halo3": (2, h + 6, 12, 8), "conv3": (2, h, 12, 16),
           "conv7": (2, h, 12, 1), "upsample": (2, 2 * h, 24, 8)}
    g = {k: rng.normal(0, 1, (SP, *s)).astype(np.float32) for k, s in out.items()}
    w = {"conv3": (rng.normal(0, 0.2, (3, 3, 8, 16))).astype(np.float32),
         "conv7": (rng.normal(0, 0.2, (7, 7, 2, 1))).astype(np.float32)}
    yolo = {"conv_s2": (2, h // 2, 6, 16), "maxpool5": (2, h, 12, 8)}
    g.update({k: rng.normal(0, 1, (SP, *s)).astype(np.float32) for k, s in yolo.items()})
    w["conv_s2"] = rng.normal(0, 0.2, (3, 3, 8, 16)).astype(np.float32)
    return {"x": x, "g": g, "w": w, "device": device}


def _operands(data: dict, name: str, rows=slice(None)) -> tuple:
    x = torch.from_numpy(data["x"][:, rows]).to(data["device"]).requires_grad_()
    w = data["w"].get(name)
    return x, None if w is None else torch.from_numpy(w).to(data["device"]).requires_grad_()


def halo_case(mesh, data: dict) -> dict:
    """This rank's band of ``data["x"]`` through the halo exchange (k = 1, 3),
    a 3x3 conv that the dispatch rule routes to the kernel, unet_sa's 7x7
    conv, the bilinear upsample, YOLO's 3x3 stride-2 conv and its 5x5 SPPF
    pool, each with the backward of sum(out * g) for this rank's ``g``, in
    f32 on ``data["device"]``; -> (out, dx, dw) of each on the CPU."""
    out, shard = {}, mesh.shard
    band = band_rows(mesh, data["x"].shape[1])
    with exact_f32():
        for name, fn in _halo_ops(shard).items():
            x, w = _operands(data, name, band)
            y = fn(x, w)
            g = torch.from_numpy(data["g"][name][shard.index]).to(y.device)
            (y * g).sum().backward()
            out[name] = (y.detach().cpu(), x.grad.cpu(), None if w is None else w.grad.cpu())
    return out


def whole_case(name: str, data: dict) -> tuple:
    """What the ranks' outputs of :func:`halo_case` must equal: the
    unsharded op's rows of each band, its input gradient from every band's
    g, and its weight gradient, on the CPU."""
    x, w = _operands(data, name)
    h = x.shape[1] // SP
    g = torch.from_numpy(data["g"][name]).to(x.device)
    with exact_f32():
        if name.startswith("halo"):
            k = int(name[-1])
            padded = torch.nn.functional.pad(x, (0, 0, 0, 0, k, k))
            ys = [padded[:, r * h:r * h + h + 2 * k] for r in range(SP)]
        else:
            y = _halo_ops(None)[name](x, w)
            out_h = y.shape[1] // SP
            ys = [y[:, r * out_h:(r + 1) * out_h] for r in range(SP)]
        sum((y * g[r]).sum() for r, y in enumerate(ys)).backward()
    return [y.detach().cpu() for y in ys], x.grad.cpu(), None if w is None else w.grad.cpu()


def check_halo(results: list, name: str, data: dict) -> None:
    """The ranks' ``halo_case`` outputs of op ``name`` against
    :func:`whole_case`: the halo exchange exactly (the boundary rows'
    gradients include the neighbour's halo rows'), the others to 1e-5 (sums
    in another order); the weight gradients summed over the ranks."""
    ys, dx, dw = whole_case(name, data)
    h = data["x"].shape[1] // SP
    exact = name.startswith("halo")
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-5, atol=1e-5)
    for r, result in enumerate(results):
        y, x_grad, w_grad = result["halo"][name]
        torch.testing.assert_close(y, ys[r], **tol)
        torch.testing.assert_close(x_grad, dx[:, r * h:(r + 1) * h], **tol)
    if exact:  # the boundary rows took gradient from the neighbour's halo
        k = int(name[-1])
        g = data["g"][name]
        np.testing.assert_array_equal(results[0]["halo"][name][1][:, -k:].numpy(),
                                      g[0][:, -2 * k:-k] + g[1][:, :k])
    if dw is not None:
        torch.testing.assert_close(sum(r["halo"][name][2] for r in results), dw,
                                   rtol=1e-5, atol=1e-5)


def spatial_cases(rank, group, dp: int, sp: int, cases: dict) -> dict:
    """Every case of ``cases`` ({name: (kind, spec)}) on the (dp, sp) layout."""
    torch.manual_seed(0)
    mesh = make_dp_spatial_mesh(dp, sp)
    kinds = {"step": step_case, "forward": forward_case, "halo": halo_case}
    return {name: kinds[kind](mesh, spec) for name, (kind, spec) in cases.items()}
