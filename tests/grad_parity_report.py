"""Where the port's train-step gradients stand against JAX's, on the CPU.

    JAX_PLATFORMS=cpu python tests/grad_parity_report.py

For each UNet variant of ``test_torch_train.py`` (unet_t widths, (2, 64, 64)
rectangles) and two seeds, one line of the largest difference between
clipped gradients, as a share of the largest gradient: JAX's jitted f32
against its eager f32, the port's f32 step against each of them, against
JAX's jitted f64 (``jax.enable_x64``) and against the port's own f64 run,
with the number of ReLU inputs whose sign differs between the port's f32
and f64 forwards, and the port's grad norm against JAX's f64 one.  Not
collected by pytest; it prints and exits 0.
"""

import copy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import random_unet_params, rect_batch  # noqa: E402
from unet_medical_image_contour_segmentation_torch.engine.optim import (  # noqa: E402
    RMSpropConfig,
    clip_by_global_norm,
)
from unet_medical_image_contour_segmentation_torch.engine.train import (  # noqa: E402
    make_train_step,
)
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3  # noqa: E402
from unet_medical_image_contour_segmentation_torch.losses.compound import (  # noqa: E402
    LossConfig,
    compute_loss,
)
from unet_medical_image_contour_segmentation_torch.models import blocks  # noqa: E402
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (  # noqa: E402
    params_tree_from_tensors,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import UNet  # noqa: E402
from unet_medical_image_contour_segmentation_tpu.engine import optim as JO  # noqa: E402
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL  # noqa: E402
from unet_medical_image_contour_segmentation_tpu.models.unet import UNet as JaxUNet  # noqa: E402

WIDTHS_T = (8, 16, 32, 64, 128)
VARIANTS = {  # name: (model kwargs, weight kwargs, loss kwargs)
    "multiclass": ({}, {}, {}),
    "binary": (dict(n_classes=1), dict(n_classes=1), dict(n_classes=1)),
    "unet_sa": (dict(use_attention=True), dict(attention=True), {}),
    "bilinear": (dict(bilinear=True), dict(bilinear=True), {}),
    "remat": (dict(remat=True), {}, {}),
}


def leaves(tree) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def port_f64(model, batch, loss_cfg):
    """The port's clipped gradients in f64 (the plain conv: the kernel takes
    bf16 and f32 only) and the inputs of every ReLU."""
    relu_in = []
    bn_apply, dtypes = blocks._bn_apply, conv3x3._DTYPES

    def recorded(bn, y, training):
        out = bn_apply(bn, y, training)
        relu_in.append(out.detach())
        return out

    blocks._bn_apply, conv3x3._DTYPES = recorded, dtypes + (torch.float64,)
    try:
        m = copy.deepcopy(model).double().train()
        loss, _ = compute_loss(m(torch.from_numpy(batch["image"]).double()),
                               torch.from_numpy(batch["mask"]), loss_cfg)
        loss.backward()
    finally:
        blocks._bn_apply, conv3x3._DTYPES = bn_apply, dtypes
    grads = [p.grad for p in m.parameters()]
    clip_by_global_norm(grads, 1.0)
    return params_tree_from_tensors(m, {n: p.grad for n, p in m.named_parameters()}), relu_in


def relu_inputs_f32(model, batch) -> list:
    relu_in = []
    bn_apply = blocks._bn_apply

    def recorded(bn, y, training):
        out = bn_apply(bn, y, training)
        relu_in.append(out.detach())
        return out

    blocks._bn_apply = recorded
    try:
        copy.deepcopy(model).train()(torch.from_numpy(batch["image"]))
    finally:
        blocks._bn_apply = bn_apply
    return relu_in


def report(name: str, seed: int) -> str:
    kw, wkw, lkw = VARIANTS[name]
    params, bn_state = random_unet_params(seed, widths=WIDTHS_T, **wkw)
    batch = rect_batch(170 + seed, 2, 64, 64)
    model = UNet(widths=WIDTHS_T, name="unet_t", **kw)
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    jax_model = JaxUNet(widths=WIDTHS_T, layout="nhwc", name="unet_t", **kw)
    jax_cfg = JL.LossConfig(**lkw)

    def grads(dtype, jit):
        def loss_fn(p):
            logits, _ = jax_model.apply(p, jax.tree.map(lambda a: jnp.asarray(a, dtype), bn_state),
                                        jnp.asarray(batch["image"], dtype), train=True)
            return JL.compute_loss(logits, jnp.asarray(batch["mask"]), jax_cfg)[0]

        g = (jax.jit(jax.grad(loss_fn)) if jit else jax.grad(loss_fn))(
            jax.tree.map(lambda a: jnp.asarray(a, dtype), params))
        clipped, norm = JO.clip_by_global_norm(g, 1.0)
        return leaves(clipped), float(norm)

    (eager, _), (jitted, _) = grads(jnp.float32, False), grads(jnp.float32, True)
    with jax.enable_x64():
        f64, norm64 = grads(jnp.float64, True)
    relu32 = relu_inputs_f32(model, batch)
    own64, relu64 = port_f64(model, batch, LossConfig(**lkw))
    step = make_train_step(model, LossConfig(**lkw), RMSpropConfig(learning_rate=1e-4))
    norm = step({k: torch.from_numpy(v) for k, v in batch.items()}, 1e-4)["grad_norm"].item()
    port = leaves(params_tree_from_tensors(
        model, {n: p.grad for n, p in model.named_parameters()}))
    g_max = max(np.abs(g).max() for g in f64)

    def gap(a, b):
        return max(np.abs(x - y).max() for x, y in zip(a, b)) / g_max

    flips = sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(relu32, relu64))
    return (f"{name:10s} seed {seed}: jit-eager {gap(jitted, eager):.3g}; port vs eager "
            f"{gap(port, eager):.3g}, vs jit {gap(port, jitted):.3g}, vs JAX f64 "
            f"{gap(port, f64):.3g} ({gap(port, f64) * g_max:.3g} abs), vs own f64 "
            f"{gap(port, leaves(own64)):.3g}; ReLU flips f32/f64 {flips}; grad norm vs JAX "
            f"f64 rel {abs(norm - norm64) / norm64:.3g}")


def main() -> int:
    torch.set_num_threads(2)
    print("largest |difference| of clipped gradients / largest gradient (JAX f64's)")
    for name in VARIANTS:
        for seed in (0, 1):
            print(report(name, seed), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
