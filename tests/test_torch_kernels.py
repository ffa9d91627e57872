"""The port's 3x3 conv kernel module against the JAX package.

On the CPU the wrapper runs the kernel's plain version; it is held against
the JAX Pallas kernel in interpret mode and against the JAX NHWC conv, in
f32.  The CUDA kernel itself is checked on the card by
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
from unet_medical_image_contour_segmentation_torch.ops import s2d as TS
from unet_medical_image_contour_segmentation_tpu.ops import s2d as JS
from unet_medical_image_contour_segmentation_tpu.ops.nn import conv2d as jax_conv2d
from unet_medical_image_contour_segmentation_tpu.ops.pallas_conv import (
    conv_s2d_b4_im2col as jax_conv_s2d_b4_im2col,
)


def _xw(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("cin,cout", [(16, 16), (32, 16), (8, 4)])
def test_s2d_contract_matches_pallas_interpret(cin, cout):
    x, w = _xw(30, (2, 24, 24), cin, cout)
    xs = np.array(JS.s2d(jnp.asarray(x), 4))
    want = np.asarray(jax_conv_s2d_b4_im2col(jnp.asarray(xs), jnp.asarray(w)))
    got = K.conv_s2d_b4_im2col(torch.from_numpy(xs), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_s2d_d2s_match_jax(b):
    x = np.random.default_rng(1).standard_normal((2, 8, 12, 3)).astype(np.float32)
    got = TS.s2d(torch.from_numpy(x), b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JS.s2d(jnp.asarray(x), b)))
    np.testing.assert_array_equal(TS.d2s(got, b).numpy(), x)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 16, 16), 16, 16),
    ((1, 13, 19), 24, 40),   # ragged: no dimension a multiple of the tile
    ((2, 9, 7), 32, 64),
    ((1, 5, 6), 8, 3),
])
def test_conv3x3_nhwc_matches_jax_conv(shape, cin, cout):
    x, w = _xw(31, shape, cin, cout)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), padding=1))
    got = K.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_cpu_calls_leave_launch_counter_at_zero():
    K.conv3x3_nhwc.launches = 0
    x, w = _xw(32, (1, 8, 8), 16, 16)
    K.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w))
    K.conv_s2d_b4_im2col(TS.s2d(torch.from_numpy(x), 4), torch.from_numpy(w))
    assert K.conv3x3_nhwc.launches == 0


def test_bf16_rounds_the_f32_sum():
    x, w = _xw(33, (1, 6, 10), 16, 8)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = K.conv3x3_nhwc(xb, wb)
    assert got.dtype == torch.bfloat16
    want = K.conv3x3_nhwc(xb.float(), wb.float()).bfloat16()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("cin", [7, 65])
def test_rejects_unsupported_cin(cin):
    """The kernel takes 8 <= Cin <= 64 (64: the dx of a 32 -> 64 conv)."""
    x, w = _xw(34, (1, 8, 8), cin, 16)
    with pytest.raises(ValueError, match="Cin"):
        K.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w))


@pytest.mark.parametrize("xdt,wdt", [
    (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32),
    (torch.float16, torch.float16),
])
def test_rejects_dtype_mismatch(xdt, wdt):
    x, w = _xw(35, (1, 8, 8), 16, 16)
    with pytest.raises(TypeError, match="dtype"):
        K.conv3x3_nhwc(torch.from_numpy(x).to(xdt), torch.from_numpy(w).to(wdt))


def test_rejects_bad_layouts():
    x, w = _xw(36, (1, 8, 8), 16, 16)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="contiguous"):
        K.conv3x3_nhwc(xt.transpose(1, 2), wt)
    with pytest.raises(ValueError, match="channels"):
        K.conv3x3_nhwc(xt[..., :12].contiguous(), wt)
    with pytest.raises(ValueError):
        K.conv3x3_nhwc(xt, wt[:2])


@pytest.mark.parametrize("w_shape,stride,padding,want", [
    ((3, 3, 16, 16), 1, 1, True),
    ((3, 3, 8, 64), 1, 1, True),
    ((3, 3, 32, 1), 1, 1, True),
    ((3, 3, 64, 64), 1, 1, False),
    ((3, 3, 4, 16), 1, 1, False),
    ((3, 3, 16, 16), 2, 1, False),
    ((3, 3, 16, 16), 1, 0, False),
    ((1, 1, 16, 3), 1, 0, False),
])
def test_dispatch_rule(w_shape, stride, padding, want):
    assert K.supported(w_shape, stride, padding) is want
