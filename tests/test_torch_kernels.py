"""The port's 3x3 conv kernel module against the JAX package.

On the CPU the wrapper runs the kernel's plain version; it is held against
the JAX Pallas kernel in interpret mode and against the JAX NHWC conv, in
f32.  The CUDA kernel itself is checked on the card by
``tests/test_torch_gpu.py``.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.kernels import _build
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
from unet_medical_image_contour_segmentation_torch.kernels._build import LAUNCHES
from unet_medical_image_contour_segmentation_torch.ops import s2d as TS
from unet_medical_image_contour_segmentation_tpu.ops import s2d as JS
from unet_medical_image_contour_segmentation_tpu.ops.nn import conv2d as jax_conv2d
from unet_medical_image_contour_segmentation_tpu.ops.pallas_conv import (
    conv_s2d_b4_im2col as jax_conv_s2d_b4_im2col,
)

REPO = Path(__file__).resolve().parent.parent
PORT = "unet_medical_image_contour_segmentation_torch"


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
    LAUNCHES.clear()
    x, w = _xw(32, (1, 8, 8), 16, 16)
    K.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w))
    K.conv_s2d_b4_im2col(TS.s2d(torch.from_numpy(x), 4), torch.from_numpy(w))
    assert LAUNCHES["conv3x3_nhwc"] == 0


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


_TC_CIN = [8, 9, 16, 24, 32, 64]
_TC_COUT = [1, 3, 16, 17, 40, 64, 80]


@pytest.mark.parametrize("cout", _TC_COUT)
@pytest.mark.parametrize("cin", _TC_CIN)
def test_tiled_reference_matches_plain_and_jax(cin, cout):
    """The tensor-core kernel's arithmetic through its launch geometry (Cin
    zero-padded to a multiple of 16, Cout cut into chunks of up to 64,
    padded with zero columns, a sum over the 9 taps) against the plain
    version and JAX's NHWC conv, in f32."""
    x, w = _xw(50, (2, 5, 11), cin, cout)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = K.conv3x3_nhwc_tiled_reference(xt, wt).numpy()
    np.testing.assert_allclose(got, K.conv3x3_nhwc_reference(xt, wt).numpy(),
                               rtol=1e-4, atol=1e-5)
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), padding=1))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(9, 17), (24, 40), (64, 80), (8, 1)])
def test_tiled_reference_matches_pallas_interpret(cin, cout):
    """The same, in the TPU kernel's s2d contract, against the Pallas kernel
    in interpret mode."""
    x, w = _xw(51, (1, 8, 12), cin, cout)
    xs = np.array(JS.s2d(jnp.asarray(x), 4))
    want = np.asarray(jax_conv_s2d_b4_im2col(jnp.asarray(xs), jnp.asarray(w)))
    got = TS.s2d(K.conv3x3_nhwc_tiled_reference(torch.from_numpy(x), torch.from_numpy(w)), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,h,w,cout", [
    (1, 1, 3, 1), (2, 1, 65, 80), (3, 17, 31, 17), (2, 37, 53, 40), (1, 33, 65, 64),
    (8, 128, 128, 64), (2, 19, 45, 200), (8, 256, 256, 16),
])
def test_launch_geometry_covers_every_output_once(dtype, b, h, w, cout):
    """The blocks of the grid, each cut at the image edge and at Cout, cover
    every output pixel and channel exactly once."""
    geo = K.launch_geometry(b, h, w, 16, cout, dtype)
    (gx, gy, gz), (th, tw), n = geo.grid, geo.tile, geo.cout_chunk
    seen = np.zeros((b, h, w, cout), np.int32)
    for bz in range(gz):
        img, chunk = divmod(bz, geo.n_chunks)
        for by in range(gy):
            for bx in range(gx):
                seen[img, by * th:(by + 1) * th, bx * tw:(bx + 1) * tw,
                     chunk * n:(chunk + 1) * n] += 1
    assert (seen == 1).all()
    assert gz == b * geo.n_chunks and (gx - 1) * tw < w and (gy - 1) * th < h


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_geometry_fits_shared_memory(dtype):
    """Every 8 <= Cin <= 64 and any Cout stays within a block's 232,448 bytes."""
    for cin in range(K.CIN_MIN, K.CIN_MAX + 1):
        for cout in range(1, 257):
            geo = K.launch_geometry(1, 8, 8, cin, cout, dtype)
            assert geo.smem_bytes <= K.SMEM_MAX == 232_448, (cin, cout, geo)
            assert geo.cin_padded >= cin and geo.cout_chunk * geo.n_chunks >= cout


@pytest.mark.parametrize("cin,cout,dtype,smem", [
    (16, 16, torch.bfloat16, 23_232),    # 10x34 halo at 48 B + 144 weight rows at 48 B
    (32, 64, torch.bfloat16, 68_672),    # 340 x 80 B + 288 x 144 B
    (64, 32, torch.bfloat16, 95_040),    # 340 x 144 B + 576 x 80 B
    (8, 1, torch.bfloat16, 18_624),      # Cin padded to 16: 340 x 48 B + 144 x 16 B
    (64, 16, torch.float32, 195_984),    # 9*64*16 f32 weights + 18x34 halo at 65 words
])
def test_launch_geometry_shared_memory_by_hand(cin, cout, dtype, smem):
    assert K.launch_geometry(8, 512, 512, cin, cout, dtype).smem_bytes == smem


def test_route_is_decided_by_dtype_without_a_launch(monkeypatch):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core kernel, and
    neither the route nor the geometry needs the built library."""
    monkeypatch.setattr(_build, "load_library", lambda name: pytest.fail("the library was loaded"))
    assert K.route(torch.bfloat16) == "tensor_core"
    assert K.route(torch.float32) == "cuda_core"
    for dtype in (torch.bfloat16, torch.float32):
        assert K.launch_geometry(2, 16, 16, 16, 16, dtype).route == K.route(dtype)
    with pytest.raises(TypeError, match="float16"):
        K.route(torch.float16)


def test_cpu_bf16_calls_count_no_launch():
    x, w = _xw(52, (1, 8, 8), 16, 16)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    LAUNCHES.clear()
    K.conv3x3_nhwc(xb, wb)
    K.conv3x3_nhwc_dx(xb, wb)
    assert sum(LAUNCHES.values()) == 0


def test_kernel_ops_leave_dynamo_unimported():
    """The three hand-kernel ops, called on CPU tensors, and one served unet_s
    forward import no ``torch._dynamo`` (whose import is seconds of set-up
    and whose wrapper is dispatch cost a call): a fresh process, no JAX."""
    code = f"""
import sys
import numpy as np
import torch
from {PORT}.engine.predict import Predictor
from {PORT}.kernels import bias_relu, conv3x3, conv3x3_int8
from {PORT}.models.unet import unet_s
g = torch.Generator().manual_seed(0)
x, w = torch.randn(1, 8, 8, 16, generator=g), torch.randn(3, 3, 16, 16, generator=g)
conv3x3.conv3x3_nhwc(x, w)
bias_relu.bias_relu_nhwc(x, torch.randn(16, generator=g))
wp = conv3x3_int8.pack_weight(torch.randint(-127, 128, (3, 3, 16, 16), dtype=torch.int8))
conv3x3_int8.conv3x3_int8(torch.randint(0, 128, (1, 8, 8, 16), dtype=torch.int8), wp,
                          torch.rand(16, generator=g), torch.rand(16, generator=g))
Predictor(unet_s(), device="cpu").predict_array(np.random.default_rng(0).random(
    (1, 64, 64), dtype=np.float32))
assert "torch._dynamo" not in sys.modules, "torch._dynamo was imported"
print("NO_DYNAMO")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NO_DYNAMO" in r.stdout


SCHEMAS = {
    "conv3x3_nhwc": "umics::conv3x3_nhwc(Tensor x, Tensor w) -> Tensor",
    "conv3x3_int8": 'umics::conv3x3_int8(Tensor x, Tensor wp, Tensor mul, Tensor badd, '
                    'ScalarType out_dtype, Tensor? x2, str act="relu", Tensor? inv_s=None) '
                    '-> Tensor',
    "bias_relu_nhwc": "umics::bias_relu_nhwc(Tensor y, Tensor b) -> Tensor",
}


@pytest.mark.parametrize("op", SCHEMAS)
def test_op_schema_is_unchanged(op):
    """The operators' schemas, which exported ``.pt2`` programs name: a program
    exported by an earlier version loads only while these stay as they are."""
    from unet_medical_image_contour_segmentation_torch.kernels import (  # noqa: F401
        bias_relu,
        conv3x3_int8,
    )

    assert str(getattr(torch.ops.umics, op).default._schema) == SCHEMAS[op]
