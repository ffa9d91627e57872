"""The port on the card: each hand kernel against its plain version, and the
main path's launches.  Every test carries the ``gpu`` marker and skips where
there is no CUDA device.

This file imports no JAX (the machine with the card has none), so on the
card it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch import exact_f32
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
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


def test_conv3x3_refuses_grad(cuda):
    x, w = _xw(41, (1, 8, 8), 16, 16, cuda, torch.float32)
    with pytest.raises(RuntimeError, match="backward"):
        K.conv3x3_nhwc(x.requires_grad_(), w)


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
