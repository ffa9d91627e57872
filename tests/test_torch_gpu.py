"""The port on the card: each hand kernel (and the 3x3 conv's gradients)
against its plain version, and the predict and train paths' launches.  Every test carries the ``gpu`` marker and skips where
there is no CUDA device.

This file imports no JAX (the machine with the card has none), so on the
card it runs without the suite's conftest, from the repo root (it takes
seeded weights and batches from ``chip_smoke.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import rect_batch, seeded_unet_s
from unet_medical_image_contour_segmentation_torch import exact_f32
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import make_train_step
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s
from unet_medical_image_contour_segmentation_torch.ops.nn import conv2d

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _xw(seed, shape, cin, cout, device, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((*shape, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 64, 64), 16, 16), ((1, 37, 53), 24, 40), ((2, 33, 65), 32, 64), ((1, 5, 3), 8, 1),
    ((3, 17, 31), 9, 17),
])
def test_conv3x3_kernel_matches_plain(cuda, dtype, tol, shape, cin, cout):
    x, w = _xw(40, shape, cin, cout, cuda, dtype)
    before = K.conv3x3_nhwc.launches
    with exact_f32():
        got = K.conv3x3_nhwc(x, w)
        want = K.conv3x3_nhwc_reference(x, w)
        torch.cuda.synchronize()
    assert K.conv3x3_nhwc.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 32, 32), 32, 64),   # dx has Cin = 64
    ((1, 37, 53), 24, 40),
    ((2, 64, 64), 16, 16),
])
def test_conv3x3_grad_matches_plain(cuda, dtype, tol, shape, cin, cout):
    """dx (the kernel, rotated weight) and dw (cuDNN's weight gradient)
    against autograd through the plain version in f32, cast once.  dw sums
    B*H*W products, so its atol is relative to its largest element."""
    x, w = _xw(41, shape, cin, cout, cuda, dtype)
    g = torch.from_numpy(np.random.default_rng(44).standard_normal((*shape, cout))
                         .astype(np.float32)).to(cuda, dtype)
    before = K.conv3x3_nhwc_dx.launches
    with exact_f32():
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        K.conv3x3_nhwc(xg, wg).backward(g)
        xr = x.detach().float().requires_grad_()
        wr = w.detach().float().requires_grad_()
        K.conv3x3_nhwc_reference(xr, wr).backward(g.float())
        torch.cuda.synchronize()
    assert K.conv3x3_nhwc_dx.launches == before + 1
    assert xg.grad.dtype == wg.grad.dtype == dtype
    torch.testing.assert_close(xg.grad.float(), xr.grad.to(dtype).float(), rtol=tol, atol=tol)
    dw_want = wr.grad.to(dtype).float()
    torch.testing.assert_close(wg.grad.float(), dw_want, rtol=tol,
                               atol=tol * dw_want.abs().max().item())


def _rect_batch(device):
    return {k: torch.from_numpy(v).to(device) for k, v in rect_batch(45, 2, 64, 96).items()}


def test_train_step_on_card_matches_cpu(cuda):
    """One f32 step (TF32 off): the loss to 1e-4; every gradient to 1e-3 of
    the model's largest gradient (a nearly cancelling gradient, such as a
    ConvTranspose bias before a train-mode BN, holds only f32 rounding) and
    so the grad norm to 1e-3 (on the H100 at four batch seeds: up to 5.9e-4
    and 1.8e-4); a parameter may differ by up to 20 * lr plus its f32
    rounding, since RMSprop's first step moves it by just under
    10 * lr * sign(g) whatever |g|."""
    lr = 1e-4
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = seeded_unet_s().to(dev)
        step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=lr))
        with exact_f32():
            metrics = step(_rect_batch(dev), lr)
        out[dev.type] = ({k: v.item() for k, v in metrics.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()},
                         {n: p.detach().cpu() for n, p in model.named_parameters()})
    (m_card, g_card, p_card), (m_cpu, g_cpu, p_cpu) = out["cuda"], out["cpu"]
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-4)
    assert m_card["grad_norm"] == pytest.approx(m_cpu["grad_norm"], rel=1e-3)
    g_max = max(g.abs().max() for g in g_cpu.values())
    for n in g_cpu:
        assert (g_card[n] - g_cpu[n]).abs().max() <= 1e-3 * g_max, n
        assert (p_card[n] - p_cpu[n]).abs().max() <= 20 * lr + 1e-6, n


def test_train_step_launches_14_kernels(cuda):
    """unet_s in bf16: each step runs the 3x3 kernel 7 times forward and 7
    times as dx."""
    model = seeded_unet_s(torch.bfloat16).to(cuda)
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=1e-4))
    batch = _rect_batch(cuda)
    fwd, dx = K.conv3x3_nhwc.launches, K.conv3x3_nhwc_dx.launches
    for _ in range(2):
        metrics = step(batch, 1e-4)
    torch.cuda.synchronize()
    assert (K.conv3x3_nhwc.launches - fwd, K.conv3x3_nhwc_dx.launches - dx) == (14, 14)
    assert np.isfinite(metrics["loss"].item())


def test_conv2d_dispatches_by_rule(cuda):
    x, w = _xw(42, (1, 16, 16), 16, 8, cuda, torch.float32)
    before = K.conv3x3_nhwc.launches
    with torch.no_grad():
        conv2d(x, w, padding=1)                 # the rule: kernel
        conv2d(x, w, padding=0)                 # no padding: cuDNN
        conv2d(x[..., :4], w[:, :, :4], padding=1)  # Cin 4: cuDNN
    assert K.conv3x3_nhwc.launches == before + 1


def test_predictor_on_card_matches_cpu(cuda):
    torch.manual_seed(0)
    model = unet_s()
    images = np.random.default_rng(43).random((2, 64, 96), dtype=np.float32)
    before = K.conv3x3_nhwc.launches
    with exact_f32():
        got = Predictor(model, device=cuda).predict_array(images)
    assert K.conv3x3_nhwc.launches == before + 7  # one forward of unet_s
    want = Predictor(model, device="cpu").predict_array(images)
    assert got.shape == want.shape == (2, 64, 96)
    assert (got == want).mean() > 0.999
