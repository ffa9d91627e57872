"""The port's 3x3 conv gradients against the JAX package, on the CPU, in f32.

On the CPU the autograd Function runs the kernel's plain version forward and
for dx, and the plain im2col product for dw; the CUDA kernel's dx is held
against the same plain version on the card by ``tests/test_torch_gpu.py``.
Tolerances: dx sums at most 9*64 products (rtol 1e-4, atol 1e-5); dw sums
B*H*W products (atol 2e-4, as ``tests/test_s2d.py`` allows the Pallas VJP).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
from unet_medical_image_contour_segmentation_torch.kernels._build import LAUNCHES
from unet_medical_image_contour_segmentation_torch.ops import s2d as TS
from unet_medical_image_contour_segmentation_torch.ops.nn import conv2d as torch_conv2d
from unet_medical_image_contour_segmentation_tpu.ops import s2d as JS
from unet_medical_image_contour_segmentation_tpu.ops.nn import conv2d as jax_conv2d
from unet_medical_image_contour_segmentation_tpu.ops.pallas_conv import (
    conv_s2d_b4_im2col as jax_conv_s2d_b4_im2col,
)

DX_TOL = dict(rtol=1e-4, atol=1e-5)
DW_TOL = dict(rtol=1e-4, atol=2e-4)


def _xw(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*shape, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, w


def _torch_grads(fn, x, w):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.sin(fn(xt, wt)).sum().backward()
    return xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("cin,cout", [(16, 8), (16, 16), (32, 16)])
def test_s2d_contract_grads_match_pallas_interpret(cin, cout):
    """dx and dw through the port's s2d wrapper against jax.grad through the
    Pallas kernel's custom VJP (interpret mode)."""
    x, w = _xw(50, (1, 32, 32), cin, cout)
    xs = np.array(JS.s2d(jnp.asarray(x), 4))
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(jax_conv_s2d_b4_im2col(a, b))),
                    argnums=(0, 1))(jnp.asarray(xs), jnp.asarray(w))
    got = _torch_grads(K.conv_s2d_b4_im2col, xs, w)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **DX_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **DW_TOL)


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 16, 16), 16, 16),
    ((2, 9, 7), 32, 64),     # dx runs the kernel with Cin = 64
    ((1, 13, 19), 24, 40),   # ragged: no dimension a multiple of the tile
    ((1, 8, 12), 64, 32),    # Cin = 64 forward (a dx-sized input)
    ((2, 6, 5), 8, 8),
])
def test_nhwc_grads_match_jax_conv(shape, cin, cout):
    x, w = _xw(51, shape, cin, cout)
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(jax_conv2d(a, b, padding=1))),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = _torch_grads(K.conv3x3_nhwc, x, w)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **DX_TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **DW_TOL)


def test_conv2d_dispatch_grads_match_jax_under_bf16_cast():
    """Through ops.nn.conv2d with an f32 master weight and bf16 compute: the
    gradients come back in f32 (autograd casts dw back, as JAX's astype
    does) and match JAX's within bf16 rounding."""
    x, w = _xw(52, (2, 12, 12), 16, 32)
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(
        jax_conv2d(a, b, padding=1, compute_dtype=jnp.bfloat16).astype(jnp.float32))),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    torch.sin(torch_conv2d(xt, wt, padding=1, compute_dtype=torch.bfloat16).float()).sum(
    ).backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.float32
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want[0]), rtol=2e-2, atol=2e-2)
    scale = np.abs(np.asarray(want[1])).max()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want[1]), rtol=2e-2,
                               atol=2e-2 * scale)


def test_dx_is_the_conv_with_the_rotated_weight():
    """dx == conv(g, w[::-1, ::-1].transpose(0, 1, 3, 2)), the identity the
    JAX VJP uses (pallas_conv.py:182-183), and dx/dw equal the plain
    functions exactly on the CPU."""
    x, w = _xw(53, (2, 10, 11), 16, 24)
    g = torch.from_numpy(np.random.default_rng(54).standard_normal((2, 10, 11, 24))
                         .astype(np.float32))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    K.conv3x3_nhwc(xt, wt).backward(g)
    w_rot = torch.from_numpy(np.ascontiguousarray(w[::-1, ::-1].transpose(0, 1, 3, 2)))
    torch.testing.assert_close(xt.grad, K.conv3x3_nhwc_reference(g, w_rot), rtol=0, atol=0)
    torch.testing.assert_close(wt.grad, K.conv3x3_nhwc_dw_reference(torch.from_numpy(x), g),
                               rtol=0, atol=0)


def test_only_requested_grads_are_computed():
    x, w = _xw(55, (1, 8, 8), 16, 16)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    K.conv3x3_nhwc(xt, wt).sum().backward()
    assert xt.grad is None and wt.grad is not None
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w)
    K.conv3x3_nhwc(xt, wt).sum().backward()
    assert xt.grad is not None and wt.grad is None


def test_cpu_backward_leaves_launch_counters_at_zero():
    LAUNCHES.clear()
    x, w = _xw(56, (1, 8, 8), 16, 32)
    _torch_grads(K.conv3x3_nhwc, x, w)
    assert (LAUNCHES["conv3x3_nhwc"], LAUNCHES["conv3x3_nhwc_dx"]) == (0, 0)


def test_bf16_grads_stay_bf16():
    x, w = _xw(57, (1, 6, 10), 16, 8)
    xt = torch.from_numpy(x).bfloat16().requires_grad_()
    wt = torch.from_numpy(w).bfloat16().requires_grad_()
    K.conv3x3_nhwc(xt, wt).float().sum().backward()
    assert xt.grad.dtype == wt.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("cout", [4, 65])
def test_grad_through_x_needs_a_kernel_sized_cout(cout):
    """dx runs the kernel with Cin = the forward's Cout, so 8..64 only."""
    x, w = _xw(58, (1, 8, 8), 16, cout)
    with pytest.raises(ValueError, match="Cout"):
        K.conv3x3_nhwc(torch.from_numpy(x).requires_grad_(), torch.from_numpy(w))
    with torch.no_grad():  # the forward alone takes any Cout
        assert K.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w)).shape[-1] == cout


def test_s2d_wrapper_is_differentiable_in_the_grid_layout():
    """The gradient of the s2d contract equals the s2d of the NHWC gradient."""
    x, w = _xw(59, (1, 16, 16), 16, 16)
    xs = TS.s2d(torch.from_numpy(x), 4)
    g_s2d = _torch_grads(K.conv_s2d_b4_im2col, xs.numpy(), w)[0]
    xt = torch.from_numpy(x).requires_grad_()
    torch.sin(TS.s2d(K.conv3x3_nhwc(xt, torch.from_numpy(w)), 4)).sum().backward()
    np.testing.assert_allclose(g_s2d, TS.s2d(xt.grad, 4).numpy(), rtol=1e-6, atol=1e-6)
