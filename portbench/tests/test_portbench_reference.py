"""The plain reference against the port's plain CPU path, at 64² on seeded
weights, and its state_dict layout against the port's."""

import numpy as np
import pytest
import torch

from portbench import harness, traffic
from portbench.reference import unet as ref
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig

from .small import small_spec

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["unet_s.serve_batch", "unet.serve_batch"])
def test_state_dict_layout_is_the_ports(cell):
    spec = harness.cell_spec(cell)
    sd = ref.make_state_dict(spec.config, traffic.seeded(5, 0, CPU), CPU)
    port = harness.port_model(spec, sd, CPU).state_dict()
    assert list(port) == list(sd)
    assert all(port[k].shape == sd[k].shape and torch.equal(port[k], sd[k]) for k in sd)
    assert sum(v.numel() for k, v in sd.items() if k in ref.trainable(sd)) \
        == spec.config["parameters"]


def _setup(seed):
    spec = small_spec("unet_s.serve_batch", compute_dtype="float32")
    images, masks = traffic.synth_slices(spec.slices, 4, seed, CPU)
    sd = ref.make_state_dict(spec.config, traffic.seeded(seed, 0, CPU), CPU)
    return spec, images, masks, sd


def test_forward_matches_the_ports_plain_serving_path():
    spec, images, _, sd = _setup(7)
    pred = Predictor(harness.port_model(spec, sd, CPU), device="cpu", batch_size=4)
    got = pred.model(images.float() / 255.0)  # the BN-folded served forward
    want = ref.forward(sd, spec.config, ref.normalize_uint8(images))
    assert torch.allclose(got, want, atol=2e-4, rtol=2e-4)
    classes = pred.predict_array(images.numpy())
    agree = (classes == want.argmax(-1).numpy()).mean()
    assert agree > 0.999


def test_train_steps_match_the_ports_plain_step():
    spec, images, masks, sd = _setup(8)
    mix = harness.cell_spec("unet_s.train").traffic
    x = ref.normalize_uint8(images).unsqueeze(-1)
    batches = [(x[:2], masks[:2].int()), (x[2:], masks[2:].int())]
    want = ref.train_steps(sd, spec.config, batches, mix)
    o = mix["optimizer"]
    step = TrainStep(harness.port_model(spec, sd, CPU), LossConfig(n_classes=3),
                     RMSpropConfig(learning_rate=o["learning_rate"], alpha=o["alpha"],
                                   eps=o["eps"], weight_decay=o["weight_decay"],
                                   momentum=o["momentum"]), mix["gradient_clipping"])
    losses = [float(step({"image": i, "mask": m}, o["learning_rate"])["loss"])
              for i, m in batches]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-4)
    named = dict(step.model.named_parameters())
    for k, p in named.items():
        change = float((p.detach() - sd[k]).norm())
        # RMSprop's first update is lr * g / |g| for all but the tiniest
        # gradients, whose sign the order of a sum decides
        assert abs(change - want["change_norms"][k]) <= 2e-2 * max(
            want["change_norms"][k], float(np.median(list(want["change_norms"].values()))))
    # the running statistics move as torch's BN moves them, on both sides
    buffers = dict(step.model.named_buffers())
    assert set(want["bn_change_norms"]) == set(ref.bn_stats(sd))
    for k, w in want["bn_change_norms"].items():
        assert w > 0
        np.testing.assert_allclose(float((buffers[k] - sd[k]).norm()), w, rtol=1e-3)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    e8 = (ref._round(x, torch.float8_e4m3fn, 448.0) - x).abs().max()
    e16 = (x.to(torch.bfloat16).float() - x).abs().max()
    assert e8 > 4 * e16
