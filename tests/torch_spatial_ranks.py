"""Rank bodies for the port's spatial-parallel tests (tests/test_torch_spatial.py).

Like ``tests/torch_dp_ranks.py`` (whose ``run_ranks`` spawns them), this
module imports torch and the port but no JAX.  Each rank builds the
(data, spatial) layout, runs every case it is given on its block of the
global inputs, and returns the results for the test process to compare.
"""

from __future__ import annotations

import torch

from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.models.torch_compat import state_dict_from_jax
from unet_medical_image_contour_segmentation_torch.models.unet import UNet
from unet_medical_image_contour_segmentation_torch.models.unet_nested import UNetPlusPlus
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
ARCHS = {"unet": UNet, "unet_pp": UNetPlusPlus}


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


def halo_case(mesh, data: dict) -> dict:
    """This rank's band of ``data["x"]`` through the halo exchange (k = 1, 3),
    a 3x3 conv that the dispatch rule routes to the kernel, unet_sa's 7x7
    conv and the bilinear upsample, each with the backward of sum(out * g)
    for this rank's ``g``."""
    out, shard = {}, mesh.shard
    band = band_rows(mesh, data["x"].shape[1])
    ops = {
        "halo1": lambda x, w: halo_exchange(x, shard, 1),
        "halo3": lambda x, w: halo_exchange(x, shard, 3),
        "conv3": lambda x, w: conv2d(x, w, padding=1, shard=shard),
        "conv7": lambda x, w: conv2d(x[..., :2], w, padding=3, shard=shard),
        "upsample": lambda x, w: upsample_x2_align_corners(x, shard),
    }
    for name, fn in ops.items():
        x = torch.from_numpy(data["x"][:, band]).requires_grad_()
        w = torch.from_numpy(data["w"][name]).requires_grad_() if name in data["w"] else None
        y = fn(x, w)
        (y * torch.from_numpy(data["g"][name][shard.index])).sum().backward()
        out[name] = (y.detach(), x.grad, None if w is None else w.grad)
    return out


def spatial_cases(rank, group, dp: int, sp: int, cases: dict) -> dict:
    """Every case of ``cases`` ({name: (kind, spec)}) on the (dp, sp) layout."""
    torch.manual_seed(0)
    mesh = make_dp_spatial_mesh(dp, sp)
    kinds = {"step": step_case, "forward": forward_case, "halo": halo_case}
    return {name: kinds[kind](mesh, spec) for name, (kind, spec) in cases.items()}
