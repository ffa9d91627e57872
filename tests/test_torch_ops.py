"""The port's NHWC primitives (ops/nn.py, ops/resize.py) against the JAX
package's, in f32 on the CPU, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.ops import nn as T
from unet_medical_image_contour_segmentation_torch.ops import resize as TR
from unet_medical_image_contour_segmentation_tpu.ops import nn as J
from unet_medical_image_contour_segmentation_tpu.ops import resize as JR


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(a)


def _j(a):
    return jnp.asarray(a)


@pytest.mark.parametrize("k,cin,cout,stride", [
    (1, 16, 3, 1),
    (3, 16, 32, 1),   # the 3x3 kernel's dispatch rule
    (3, 4, 8, 1),     # Cin below the rule: F.conv2d
    (3, 16, 8, 2),
    (7, 2, 1, 1),
])
def test_conv2d(k, cin, cout, stride):
    x = _rand(0, 2, 15, 17, cin)
    w = _rand(1, k, k, cin, cout, scale=0.2)
    b = _rand(2, cout)
    pad = k // 2
    want = J.conv2d(_j(x), _j(w), _j(b), stride=stride, padding=pad)
    got = T.conv2d(_t(x), _t(w), _t(b), stride=stride, padding=pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_conv2d_bf16_output_dtype():
    x, w = _rand(3, 1, 8, 8, 16), _rand(4, 3, 3, 16, 16, scale=0.2)
    got = T.conv2d(_t(x), _t(w), _t(_rand(5, 16)), padding=1, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = T.conv2d(_t(x), _t(w), _t(_rand(5, 16)), padding=1)
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hw", [(4, 5), (7, 8)])
def test_conv_transpose2d_k2s2(hw):
    x = _rand(6, 2, *hw, 32)
    w = _rand(7, 2, 2, 32, 16, scale=0.2)
    b = _rand(8, 16)
    want = J.conv_transpose2d(_j(x), _j(w), _j(b), stride=2)
    got = T.conv_transpose2d(_t(x), _t(w), _t(b), stride=2)
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (5, 2)])
def test_max_pool2d_floor_mode(hw):
    x = _rand(9, 2, *hw, 3)
    want = np.asarray(J.max_pool2d(_j(x), 2))
    got = T.max_pool2d(_t(x), 2).numpy()
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(train):
    x = _rand(10, 4, 6, 5, 8) * 2 + 0.5
    scale, bias = _rand(11, 8) + 1, _rand(12, 8)
    mean, var = _rand(13, 8), np.abs(_rand(14, 8)) + 0.5
    jy, (jm, jv) = J.batch_norm(_j(x), _j(scale), _j(bias), _j(mean), _j(var), train=train)
    ty, (tm, tv) = T.batch_norm(_t(x), _t(scale), _t(bias), _t(mean), _t(var), train=train)
    # JAX takes the batch variance one-pass (E[x^2] - E[x]^2), torch two-pass
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4, atol=1e-5)


def test_batch_norm_bf16_keeps_dtype():
    x = _t(_rand(15, 2, 4, 4, 8)).bfloat16()
    ones, zeros = torch.ones(8), torch.zeros(8)
    y, _ = T.batch_norm(x, ones, zeros, zeros, ones, train=False)
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("out_hw", [(60, 100), (24, 40), (1, 7), (48, 80)])
def test_bilinear_resize(align_corners, out_hw):
    x = _rand(16, 2, 48, 80, 3)
    want = JR.bilinear_resize(_j(x), *out_hw, align_corners=align_corners)
    got = TR.bilinear_resize(_t(x), *out_hw, align_corners=align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_bilinear_resize_matches_torch_interpolate():
    x = _rand(17, 2, 12, 20, 3)
    got = TR.bilinear_resize(_t(x), 30, 16, align_corners=False)
    want = torch.nn.functional.interpolate(_t(x).permute(0, 3, 1, 2), size=(30, 16),
                                           mode="bilinear", align_corners=False)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)


def test_upsample_x2_align_corners():
    x = _rand(18, 2, 5, 7, 4)
    want = JR.upsample_x2_align_corners(_j(x))
    got = TR.upsample_x2_align_corners(_t(x))
    assert got.shape == (2, 10, 14, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
