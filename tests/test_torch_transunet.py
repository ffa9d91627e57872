"""TransUNet (``models/transunet.py``) on the CPU against the plain reference
``portbench/reference/transunet.py``: the live forward, the serving fold, a train
step's loss and gradients, the skip pad, other image sizes, the Predictor's
refusals, the published preset's sizes (on the meta device), checkpoints and
the CLIs.
The served bf16 forward at 512² runs on the card (``tests/test_torch_gpu.py``)."""

import numpy as np
import pytest
import torch
from torch import nn

from portbench.reference import transunet as R
from portbench.reference.unet import loss as reference_loss
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (
    load_weights,
    save_checkpoint,
)
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models import blocks
from unet_medical_image_contour_segmentation_torch.models.fold_bn import (
    FoldedConv2dReLU,
    serving_copy,
)
from unet_medical_image_contour_segmentation_torch.models.transunet import Conv2dReLU, StdConv2d
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_torch.ops import vit

TINY = {"model": "transunet_tiny", "n_channels": 1, "n_classes": 3}
FULL = {"model": "transunet_r50_b16", "n_channels": 1, "n_classes": 3}


def _setup(seed: int = 3, dropout: float = 0.1):
    """Seeded reference weights with BN calibrated, a tiny port model holding
    them, and four 64² images."""
    torch.manual_seed(seed)
    sd = R.make_state_dict(TINY, torch.Generator().manual_seed(seed), "cpu")
    x = torch.rand(4, 64, 64)
    R.calibrate_bn(sd, TINY, x)
    model = get_model("transunet_tiny", n_channels=1, n_classes=3, bilinear=True,
                      dropout=dropout)
    model.load_state_dict(sd, strict=True)
    return sd, model, x


def test_live_forward_matches_the_reference():
    sd, model, x = _setup()
    with torch.no_grad():
        got = model.eval()(x)
        want = R.forward(sd, TINY, x)
    assert got.shape == (4, 64, 64, 3) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4
    assert len(want.argmax(-1).unique()) > 1  # the weights do not make one class win


def test_serving_fold_matches_the_live_forward(monkeypatch):
    sd, model, x = _setup()
    served = serving_copy(model)
    mods = list(served.modules())
    assert sum(isinstance(m, FoldedConv2dReLU) for m in mods) == 9
    assert not any(isinstance(m, (Conv2dReLU, nn.BatchNorm2d)) for m in mods)
    stds = [m for m in mods if isinstance(m, StdConv2d)]
    assert stds and all(m.standardized for m in stds)
    root = served.transformer.embeddings.hybrid_model.root.conv.weight
    assert tuple(root.shape) == (8, 1, 7, 7)
    want_root = vit.standardize_weight(model.transformer.embeddings.hybrid_model.root.conv.weight)
    assert torch.allclose(root, want_root.sum(1, keepdim=True))
    bns, std_calls = [], vit.standardize_weight.calls
    bn = blocks.batch_norm
    monkeypatch.setattr(blocks, "batch_norm", lambda *a, **k: bns.append(1) or bn(*a, **k))
    with torch.no_grad():
        got = served(x)
        assert not bns and vit.standardize_weight.calls == std_calls
        live = model.eval()(x)
    assert len(bns) == 9  # the live model runs its 9 BNs
    assert float((got - live).abs().max()) <= 1e-4


def test_train_step_matches_the_reference_autograd():
    sd, model, x = _setup(dropout=0.0)
    mask = torch.randint(0, 3, (4, 64, 64))
    step = TrainStep(model, LossConfig(n_classes=3), RMSpropConfig(learning_rate=1e-5), 1e9)
    metrics = step({"image": x.unsqueeze(-1), "mask": mask}, 1e-5)
    ref = {k: v.clone().requires_grad_(True) if v.is_floating_point() and
           not k.endswith(("running_mean", "running_var")) else v.clone() for k, v in sd.items()}
    want = reference_loss(R.forward(ref, TINY, x, train=True), mask, 3, 1e-6)
    want.backward()
    assert abs(float(metrics["loss"]) - float(want.detach())) <= 1e-5
    named = dict(model.named_parameters())
    assert set(named) == {k for k, v in ref.items() if v.requires_grad}
    for name, p in named.items():
        g = ref[name].grad
        assert float((p.grad - g).abs().max()) <= 1e-5 * max(1.0, float(g.abs().max())), name
    buffers = dict(model.named_buffers())
    for name in (k for k in sd if k.endswith(("running_mean", "running_var"))):
        assert torch.allclose(buffers[name], ref[name], atol=1e-5), name


def test_block1_skip_is_padded_with_zeros():
    _, model, x = _setup()
    with torch.no_grad():
        y, skips = model.eval()._resnet(x.unsqueeze(-1), None)
    assert [tuple(s.shape[1:]) for s in skips] == [(8, 8, 64), (16, 16, 32), (32, 32, 8)]
    assert y.shape[1:3] == (4, 4)
    pad = skips[1]
    assert torch.all(pad[:, 15] == 0) and torch.all(pad[:, :, 15] == 0)
    assert torch.any(pad[:, 14] != 0)
    with torch.device("meta"):
        full = get_model("transunet_r50_b16", n_channels=1, n_classes=3, bilinear=True)
        y, skips = full._resnet(torch.empty(1, 512, 512, 1), None)
    # block 1's 127² output padded to 128², as the published feat
    assert [tuple(s.shape[1:]) for s in skips] == [(64, 64, 512), (128, 128, 256),
                                                     (256, 256, 64)]
    assert tuple(y.shape[1:]) == (32, 32, 1024)


def test_predictor_refuses_other_sizes_int8_and_tiling():
    _, model, x = _setup()
    pred = Predictor(model, device="cpu")
    assert pred.predict_array((x * 255).to(torch.uint8).numpy()).shape == (4, 64, 64)
    # sizes off the patch grid; every multiple of 16 is served (below)
    with pytest.raises(ValueError, match="multiples of 16"):
        pred.predict_array(np.zeros((1, 40, 48), np.uint8))
    with pytest.raises(ValueError, match="int8"):
        Predictor(model, device="cpu", quantize=True)
    with pytest.raises(ValueError, match="tiling"):
        Predictor(model, device="cpu", tile=32)
    with pytest.raises(ValueError, match="tiling"):
        Predictor(model, device="cpu", tile_threshold=32 * 32)
    assert pred.tile_threshold == 0  # never tiled, at any size


@pytest.mark.parametrize("hw", [(32, 32), (48, 80)])
def test_other_sizes_resample_the_position_embeddings(hw):
    # the tiny preset's 4x4 grid of position embeddings resampled to the
    # image's grid as the published load_from resamples them (the corners kept)
    sd, model, _ = _setup()
    x = torch.rand(2, *hw)
    with torch.no_grad():
        got = model.eval()(x)
        want = R.forward(sd, TINY, x)
        served = serving_copy(model)(x)
        pe = model._position_embeddings(hw[0] // 16, hw[1] // 16).view(hw[0] // 16,
                                                                        hw[1] // 16, -1)
    stored = sd["transformer.embeddings.position_embeddings"].view(4, 4, -1)
    assert torch.allclose(pe[0, 0], stored[0, 0]) and torch.allclose(pe[-1, -1], stored[-1, -1])
    assert got.shape == (2, *hw, 3)
    assert float((got - want).abs().max()) <= 1e-4
    assert float((served - want).abs().max()) <= 1e-4
    assert model._position_embeddings(4, 4) is model.transformer.embeddings.position_embeddings
    with pytest.raises(ValueError, match="bilinear"):
        get_model("transunet_tiny", bilinear=False)


def test_published_preset_sizes_on_meta():
    with torch.device("meta"):
        m = get_model("transunet_r50_b16", n_channels=1, n_classes=3, bilinear=True,
                      compute_dtype=torch.bfloat16)
    enc = m.transformer.encoder
    assert m.img_size == 512 and m.hw_divisor == 16 and m.heads == 12
    assert m.widths == (64, 256, 512, 1024, 768) and m.dropout == 0.1
    assert len(enc.layer) == 12 and enc.layer[0].ffn.fc1.out_features == 3072
    assert enc.layer[0].attn.query.in_features == 768
    body = m.transformer.embeddings.hybrid_model.body
    assert [len(b) for b in body] == [3, 4, 9]
    assert m.skip_channels == [512, 256, 64, 0]
    assert [b.conv2[0].out_channels for b in m.decoder.blocks] == [256, 128, 64, 16]
    assert m.decoder.conv_more[0].out_channels == 512
    assert m.transformer.embeddings.position_embeddings.shape == (1, 1024, 768)
    count = sum(p.numel() for p in m.parameters())
    assert count == R.parameter_count(FULL) == 105_912_115
    assert list(m.state_dict()) == list(R.state_dict_shapes(FULL))
    assert all(tuple(t.shape) == R.state_dict_shapes(FULL)[k][0]
               for k, t in m.state_dict().items())


def test_reference_in_fp8_departs_from_f32():
    # the precision one step below bf16 moves the tiny preset's logits ten
    # thousand times as far as the port's f32 forward lies from the reference
    sd, _, x = _setup()
    with torch.no_grad():
        f32, fp8 = R.forward(sd, TINY, x), R.forward(sd, TINY, x, quant="fp8")
    assert float((fp8 - f32).abs().max()) > 1.0


@pytest.mark.parametrize("suffix", [".npz", ".pth"])
def test_checkpoint_round_trip(tmp_path, suffix):
    sd, model, _ = _setup()
    path = str(tmp_path / f"tu{suffix}")
    save_checkpoint(path, model, step=3)
    got, _ = load_weights(path)
    again = get_model("transunet_tiny", n_channels=1, n_classes=3, bilinear=True)
    again.load_state_dict(got, strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_clis_take_the_model():
    from unet_medical_image_contour_segmentation_torch.cli import predict, train

    assert train.get_args(["--model", "transunet_r50_b16"]).model == "transunet_r50_b16"
    args = predict.get_args(["-m", "w.pth", "-i", "x", "--arch", "transunet_r50_b16"])
    assert args.arch == "transunet_r50_b16"
