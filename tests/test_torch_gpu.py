"""The port on the card: each hand kernel (and the 3x3 conv's gradients)
against its plain version, and the predict, int8 predict and train paths'
launches.  Every test carries the ``gpu`` marker and skips where
there is no CUDA device.

This file imports no JAX (the machine with the card has none), so on the
card it runs without the suite's conftest, from the repo root (it takes
seeded weights and batches from ``chip_smoke.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest
import torch
from torch_dp_ranks import run_ranks
from torch_spatial_ranks import check_halo, halo_data, spatial_cases

from chip_smoke import (
    INT8_CONVS,
    MODEL_SEED,
    PP_SPLIT_CONVS,
    PREFETCH_BUSY_S,
    S2_SHAPE,
    S2_TOL,
    SILU_INV_S,
    SLEEP_HZ,
    build_model,
    int8_operands,
    npz_differences,
    phase_dp_serve,
    phase_dp_two_ranks,
    prefetch_gate,
    prefetch_host_batches,
    rect_batch,
    s_check,
    s_plain_step,
    s_shapes,
    s_want,
    seeded_model as seeded_family,
    spawn_spatial,
    seeded_unet_s,
    silu_operands,
    smooth_images,
    tiled_logits,
    top2_margin,
)
from unet_medical_image_contour_segmentation_torch import exact_f32
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (
    save_checkpoint,
    save_checkpoint_async,
)
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import make_train_step
from unet_medical_image_contour_segmentation_torch.kernels import bias_relu as BR
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3 as K
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3_int8 as K8
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models.fold_bn import FoldedDoubleConv
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


@pytest.mark.parametrize("w", [3, 31, 33, 65])
@pytest.mark.parametrize("cout", [1, 3, 17, 40, 64, 80])
@pytest.mark.parametrize("cin", [9, 24, 40, 64])
def test_tensor_core_kernel_edge_shapes(cuda, cin, cout, w):
    """bf16 on the tensor-core kernel at one row, widths around the 32-pixel
    tile, Cin not a multiple of 16 (9 not even of 8: the 2-byte load path)
    and Cout not a multiple of 8 (the 2-byte store path) or above 64 (two
    chunks), against the plain version at the bf16 tolerance."""
    x, wt = _xw(46, (2, 1, w), cin, cout, cuda, torch.bfloat16)
    before = (K.conv3x3_nhwc.launches, K.conv3x3_nhwc.tensor_core_launches)
    got = K.conv3x3_nhwc(x, wt)
    want = K.conv3x3_nhwc_reference(x, wt)
    torch.cuda.synchronize()
    assert (K.conv3x3_nhwc.launches, K.conv3x3_nhwc.tensor_core_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_routes_by_dtype(cuda, dtype):
    """bf16 launches the tensor-core kernel, f32 the CUDA-core kernel."""
    x, w = _xw(47, (1, 16, 16), 16, 16, cuda, dtype)
    before = (K.conv3x3_nhwc.launches, K.conv3x3_nhwc.tensor_core_launches)
    with exact_f32():
        K.conv3x3_nhwc(x, w)
    on_tc = int(dtype == torch.bfloat16)
    assert (K.conv3x3_nhwc.launches, K.conv3x3_nhwc.tensor_core_launches) == (
        before[0] + 1, before[1] + on_tc)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_geometry_matches_the_kernel(cuda, dtype):
    """The pure-Python geometry's shared memory is the built kernel's, and
    at least one block fits on an SM, for every Cin and chunk width."""
    for cin in range(K.CIN_MIN, K.CIN_MAX + 1):
        for cout in (1, 3, 8, 9, 16, 17, 32, 33, 40, 64, 80):
            geo = K.launch_geometry(1, 8, 8, cin, cout, dtype)
            assert K.kernel_smem_bytes(cin, cout, dtype) == geo.smem_bytes, (cin, cout)
            assert K.kernel_blocks_per_sm(cin, cout, dtype) >= 1, (cin, cout)


@pytest.mark.parametrize("cin", [40, 64])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_conv3x3_dx_at_cin_64(cuda, dtype, tol, cin):
    """dx of a Cin -> 64 conv is a 64 -> Cin conv: the widest the kernels take."""
    x, w = _xw(48, (2, 19, 45), cin, 64, cuda, dtype)
    g = torch.from_numpy(np.random.default_rng(49).standard_normal((2, 19, 45, 64))
                         .astype(np.float32)).to(cuda, dtype)
    before = (K.conv3x3_nhwc_dx.launches, K.conv3x3_nhwc_dx.tensor_core_launches)
    with exact_f32():
        got = K.conv3x3_nhwc_dx(g, w)
        want = K.conv3x3_nhwc_reference(g, K.rotate_weight(w))
        torch.cuda.synchronize()
    on_tc = int(dtype == torch.bfloat16)
    assert (K.conv3x3_nhwc_dx.launches, K.conv3x3_nhwc_dx.tensor_core_launches) == (
        before[0] + 1, before[1] + on_tc)
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
    times as dx, every time on the tensor-core kernel."""
    model = seeded_unet_s(torch.bfloat16).to(cuda)
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=1e-4))
    batch = _rect_batch(cuda)
    counters = [(f, a) for f in (K.conv3x3_nhwc, K.conv3x3_nhwc_dx)
                for a in ("launches", "tensor_core_launches")]
    before = [getattr(f, a) for f, a in counters]
    for _ in range(2):
        metrics = step(batch, 1e-4)
    torch.cuda.synchronize()
    assert [getattr(f, a) - n for (f, a), n in zip(counters, before)] == [14, 14, 14, 14]
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


@pytest.fixture(scope="module")
def seeded_model():
    return build_model(MODEL_SEED)


def _tiled(model, device, dtype=None, **kw):
    return Predictor(model, device=device, compute_dtype=dtype, tile=128, tile_halo=96,
                     tile_threshold=1, **kw)


def _counts():
    return [getattr(f, a) for f in (K.conv3x3_nhwc, K.conv3x3_nhwc_dx)
            for a in ("launches", "tensor_core_launches")]


def test_tiled_on_card_matches_cpu(cuda, seeded_model):
    """f32 (TF32 off): the card's tiled masks equal the CPU's wherever the
    top-two margin of the stitched window logits exceeds 1e-3."""
    images = smooth_images(50, 1, 320)[:, :, :288]
    with exact_f32():
        card = _tiled(seeded_model, cuda)
        got = card.predict_array(images)
        margin = top2_margin(tiled_logits(card.model, torch.from_numpy(images).to(cuda), 128,
                                          96)).cpu().numpy()
    want = _tiled(seeded_model, "cpu").predict_array(images)
    ok = margin > 1e-3
    assert got.shape == want.shape == (1, 320, 288) and ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("tile_batch", [1, 4, 8])
def test_tiled_grid_launches_and_matches_host_stitching(cuda, seeded_model, tile_batch):
    """3 x 3 tiles: in bf16, 7 tensor-core launches per window-group forward
    (the last group padded with duplicates); in f32 (TF32 off) the device
    grid gives the host-stitched map (one forward per tile) on decided
    pixels.  (In bf16 the two agree on 99.77% at 4 and 8 tiles a group on
    an H100: the convs left to cuDNN run at another batch there, and a bf16
    rounding flips near-ties.)"""
    images = smooth_images(51, 2, 384)
    grid = _tiled(seeded_model, cuda, torch.bfloat16)
    grid.tile_batch = tile_batch
    before = _counts()
    grid.predict_array(images)
    forwards = -(-9 // tile_batch)
    assert [a - b for a, b in zip(_counts(), before)] == [7 * forwards, 7 * forwards, 0, 0]
    with exact_f32():
        grid, host = _tiled(seeded_model, cuda), _tiled(seeded_model, cuda)
        grid.tile_batch, host.tile_on_device = tile_batch, False
        got, want = grid.predict_array(images), host.predict_array(images)
        margin = top2_margin(tiled_logits(grid.model, torch.from_numpy(images).to(cuda), 128,
                                          96)).cpu().numpy()
    ok = margin > 1e-3
    assert got.dtype == want.dtype == np.int32 and ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])


def test_tiled_uint8_on_card(cuda, seeded_model):
    """uint8 stays uint8 in the padded buffer; each window divides by its
    image's divisor, as the host does before the float path."""
    u8 = np.round(smooth_images(52, 2, 384) * 255).astype(np.uint8)
    pred = _tiled(seeded_model, cuda, torch.bfloat16)
    got, want = pred.predict_array(u8), pred.predict_array(u8.astype(np.float32) / 255)
    assert (got == want).mean() > 0.9999


def test_tiled_interior_matches_dense_on_card(cuda, seeded_model):
    """f32: tiled equals dense at least HALO from the border, wherever both
    forwards decide the pixel by a margin above 1e-3."""
    images = smooth_images(53, 1, 384)
    x = torch.from_numpy(images).to(cuda)
    with exact_f32():
        tiled = _tiled(seeded_model, cuda)
        got = tiled.predict_array(images)
        want = Predictor(seeded_model, device=cuda, tile_threshold=0).predict_array(images)
        with torch.inference_mode():
            dense_margin = top2_margin(tiled.model(x)).cpu().numpy()
        tiled_margin = top2_margin(tiled_logits(tiled.model, x, 128, 96)).cpu().numpy()
    inner = (slice(None), slice(96, -96), slice(96, -96))
    ok = (dense_margin > 1e-3) & (tiled_margin > 1e-3)
    np.testing.assert_array_equal(got[inner][ok[inner]], want[inner][ok[inner]])
    assert (got != want).mean() > 0  # the border band differs: another function


def _int8_check(cuda, seed, b, h, w, cin, cout, out_dtype, cin2=0):
    """The int8 kernel against its plain version on the card: equal outputs
    (int32 sums are exact; the epilogue rounds as the plain one does).  With
    cin2, x's last cin2 channels go in as the split input's second part."""
    x, *ops = int8_operands(seed, b, h, w, cin + cin2, cout, cuda)
    x, x2 = (x[..., :cin].contiguous(), x[..., cin:].contiguous()) if cin2 else (x, None)
    before = K8.conv3x3_int8.launches
    got = K8.conv3x3_int8(x, *ops, out_dtype, x2)
    want = K8.conv3x3_int8_reference(x, *ops, out_dtype, x2)
    torch.cuda.synchronize()
    assert K8.conv3x3_int8.launches == before + 1
    assert got.dtype == want.dtype == out_dtype and got.shape == (b, h, w, cout)
    assert torch.equal(got, want)
    if out_dtype == torch.int8 and got.numel() > 4096:  # the requant clips at both ends
        assert (got == 0).any() and (got == 127).any()


@pytest.mark.parametrize("name,cin,cout,s,out", INT8_CONVS)
def test_int8_kernel_at_unet_s_shapes(cuda, name, cin, cout, s, out):
    """The 18 convs of unet_s at (2, 256 / s, 256 / s), each with its own
    epilogue (int8, or dequant to bf16 as on the main path)."""
    out_dtype = torch.int8 if out == "int8" else torch.bfloat16
    _int8_check(cuda, 60, 2, 256 // s, 256 // s, cin, cout, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 32, 48), 32, 32),     # YOLO's p_c2 / p_c3 and c2f0 bottleneck: N = 32
    ((1, 17, 70), 64, 64),     # p_c1 and c2f1's bottleneck, W and H off the tile
    ((1, 9, 21), 8, 24),       # Cin < 16: padded to 16 for the TMA kernel
])
def test_int8_kernel_silu_epilogues_match_plain(cuda, shape, cin, cout, out_dtype):
    """The SiLU epilogues (yolov8_seg_s: true-scale dequant to f32 / bf16,
    or the signed requant with ``inv_s``) against the plain version run on
    the card, exactly: the kernel computes torch's CUDA sigmoid."""
    x, wp, mul, badd = silu_operands(67, *shape, cin, cout, cuda)
    inv_s = torch.tensor(SILU_INV_S, device=cuda) if out_dtype == torch.int8 else None
    before = K8.conv3x3_int8.launches
    got = K8.conv3x3_int8(x, wp, mul, badd, out_dtype, act="silu", inv_s=inv_s)
    want = K8.conv3x3_int8_reference(x, wp, mul, badd, out_dtype, act="silu", inv_s=inv_s)
    torch.cuda.synchronize()
    assert K8.conv3x3_int8.launches == before + 1 and got.dtype == out_dtype
    assert torch.equal(got, want)
    if out_dtype == torch.int8:  # the signed grid: both ends of SiLU's range
        assert (want < 0).any() and (want == 127).any()
    else:
        assert (want < 0).any()


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 37, 53), 1, 16),      # inc.conv1: one channel, read as it is (im2col kernel)
    ((1, 37, 53), 24, 40),     # Cin padded to 32 by the wrapper, Cout not a wgmma N
    ((1, 32, 32), 1024, 512),  # unet's up1.conv1: 32 K chunks, 2 Cout pieces of 256
    ((3, 9, 70), 48, 72),      # N = 128 for 72 channels, W off the 64-column tile
    ((1, 5, 3), 16, 1),
    ((1, 37, 53), 8, 8),       # im2col, K = 72 in 3 steps of 32
])
def test_int8_kernel_edge_shapes(cuda, shape, cin, cout, out_dtype):
    """Cin 1, 8, 24 and 1024, Cout off the wgmma Ns, H and W off the
    tile, and all three epilogues."""
    _int8_check(cuda, 61, *shape, cin, cout, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("shape,cin,cout,cin2", [
    ((1, 19, 45), 1, 16, 0),      # Cin 1 at a W that is not a multiple of 16
    ((2, 9, 130), 3, 32, 0),      # im2col, one K step, N = 32
    ((1, 11, 21), 15, 16, 0),     # im2col, K = 135 in 5 steps
    ((2, 21, 67), 32, 1, 0),      # Cout 1
    ((1, 37, 53), 16, 8, 0),      # Cout 8
    ((1, 16, 16), 64, 1024, 0),   # Cout 1024: 4 pieces of 256
    ((1, 8, 64), 32, 16, 0),      # one tile
    ((1, 16, 64), 64, 64, 0),     # 2 tiles on 132 SMs
    ((16, 256, 256), 16, 16, 0),  # 1024 tiles, ~8 per block
    ((2, 64, 64), 16, 16, 16),    # split inputs: unet_s up4.conv1's parts
    ((2, 32, 32), 128, 128, 128),  # up1.conv1's
    ((1, 37, 53), 16, 40, 32),    # ragged, parts of 16 and 32
    ((1, 20, 20), 8, 16, 8),      # parts not multiples of 16: concatenated first
])
def test_int8_kernel_new_paths(cuda, shape, cin, cout, cin2, out_dtype):
    """The paths of the wgmma / TMA redesign: Cin < 16 through the im2col
    kernel, Cout 1 to 1024, fewer and many more tiles than SMs, one tile,
    and the split input."""
    _int8_check(cuda, 65, *shape, cin, cout, out_dtype, cin2)


@pytest.mark.parametrize("shape,cin,cout,cin2", [
    ((8, 512, 512), 1, 16, 0), ((8, 512, 512), 16, 16, 0), ((8, 32, 32), 128, 256, 0),
    ((8, 64, 64), 128, 128, 128), ((1, 32, 32), 1024, 512, 0), ((1, 37, 53), 8, 8, 0),
    ((16, 44, 44), 256, 256, 0), ((1, 5, 3), 16, 1, 0),
])
def test_int8_launch_geometry_matches_the_kernel(cuda, shape, cin, cout, cin2):
    """The pure-Python geometry is the one the built kernel takes."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert (K8.launch_geometry(*shape, cin, cout, cin2, sms=sms)
            == K8.kernel_geometry(*shape, cin, cout, cin2))


def test_int8_kernel_takes_a_misaligned_input(cuda):
    """A contiguous int8 view off a 16-byte boundary is copied to an aligned
    one before the launch (TMA reads from a 16-byte aligned base)."""
    x, wp, mul, badd = int8_operands(64, 2, 9, 33, 16, 24, cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.int8, device=cuda)
    xv = buf[1:].view(x.shape)
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    torch.testing.assert_close(K8.conv3x3_int8(xv, wp, mul, badd),
                               K8.conv3x3_int8_reference(x, wp, mul, badd, torch.int8),
                               rtol=0, atol=0)


def test_int8_kernel_raises_on_misuse(cuda):
    x, wp, mul, badd = int8_operands(62, 1, 8, 8, 16, 16, cuda)
    with pytest.raises(ValueError):
        K8.conv3x3_int8(x.float(), wp, mul, badd)          # not int8
    with pytest.raises(ValueError):  # Cin 48 against a weight packed for Cin 16
        K8.conv3x3_int8(int8_operands(62, 1, 8, 8, 48, 16, cuda)[0], wp, mul, badd)
    with pytest.raises(ValueError):
        K8.conv3x3_int8(x, wp, mul.cpu(), badd)            # two devices


def test_int8_predictor_on_card_matches_cpu(cuda, seeded_model, tmp_path):
    """An int8 Predictor in f32 (TF32 off) on the card against the same one
    on the CPU, on one calibration (calibrated on the card, loaded on the
    CPU): masks >= 99.9% equal; every conv ran int8 (18 launches)."""
    images = smooth_images(63, 2, 128)[:, :, :96]
    with exact_f32():
        card = Predictor(seeded_model, device=cuda, quantize=True)
        card.calibrate(images)
        card.save_calibration(str(tmp_path / "s.json"))
        before = (K8.conv3x3_int8.launches, K.conv3x3_nhwc.launches)
        got = card.predict_array(images)
        assert (K8.conv3x3_int8.launches - before[0], K.conv3x3_nhwc.launches - before[1]) == (
            18, 0)
    cpu = Predictor(seeded_model, device="cpu", quantize=True)
    cpu.load_calibration(str(tmp_path / "s.json"))
    want = cpu.predict_array(images)
    assert got.shape == want.shape == (2, 128, 96)
    assert (got == want).mean() >= 0.999


# -- the custom ops (torch.library) and the exported programs on the card -----


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_conv3x3_custom_op_matches_plain(cuda, dtype, tol):
    """``umics::conv3x3_nhwc`` called as an op: one launch, the plain
    version's values."""
    x, w = _xw(70, (2, 48, 80), 16, 32, cuda, dtype)
    before = K.conv3x3_nhwc.launches
    got = torch.ops.umics.conv3x3_nhwc(x, w)
    torch.cuda.synchronize()
    assert K.conv3x3_nhwc.launches == before + 1
    want = K.conv3x3_nhwc_reference(x.cpu(), w.cpu())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("cin2", [0, 16])
def test_conv3x3_int8_custom_op_matches_plain(cuda, out_dtype, cin2):
    """``umics::conv3x3_int8`` with ``out_dtype`` and the optional split
    input in its schema: one launch, exactly the plain version."""
    x, wp, mul, badd = int8_operands(71, 2, 32, 48, 16 + cin2, 32, cuda)
    x1, x2 = (x, None) if not cin2 else (x[..., :16].contiguous(), x[..., 16:].contiguous())
    before = K8.conv3x3_int8.launches
    got = torch.ops.umics.conv3x3_int8(x1, wp, mul, badd, out_dtype, x2)
    torch.cuda.synchronize()
    assert K8.conv3x3_int8.launches == before + 1 and got.dtype == out_dtype
    want = K8.conv3x3_int8_reference(x1.cpu(), wp.cpu(), mul.cpu(), badd.cpu(), out_dtype,
                                     None if x2 is None else x2.cpu())
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_custom_op_fake_implementations(cuda):
    """Under fake tensors both ops give the output's shape and dtype, and
    launch nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = (K.conv3x3_nhwc.launches, K8.conv3x3_int8.launches)
    with FakeTensorMode():
        x = torch.empty((3, 40, 24, 16), device=cuda, dtype=torch.bfloat16)
        w = torch.empty((3, 3, 16, 8), device=cuda, dtype=torch.bfloat16)
        y = torch.ops.umics.conv3x3_nhwc(x, w)
        q = torch.empty((3, 40, 24, 32), device=cuda, dtype=torch.int8)
        wp = torch.empty((1, 1, 9, 2, 8, 16), device=cuda, dtype=torch.int8)
        mul = torch.empty((8,), device=cuda)
        z = torch.ops.umics.conv3x3_int8(q, wp, mul, mul, torch.float32, None)
        assert (tuple(y.shape), y.dtype) == ((3, 40, 24, 8), torch.bfloat16)
        assert (tuple(z.shape), z.dtype) == ((3, 40, 24, 8), torch.float32)
    assert (K.conv3x3_nhwc.launches, K8.conv3x3_int8.launches) == before


def test_exported_program_on_card(cuda, seeded_model):
    """unet_s bf16 exported on the card: the program launches the kernel 7
    times a forward through the custom op, and the bias + ReLU pass 18
    times, at two sizes from one program,
    and gives the folded eval forward's logits (bf16 tolerance: the program
    may order the same ops' launches differently)."""
    from unet_medical_image_contour_segmentation_torch.engine.export import (
        export_program,
        load_exported,
    )
    from unet_medical_image_contour_segmentation_torch.models.fold_bn import fold_bn

    model = unet_s(compute_dtype=torch.bfloat16)
    model.load_state_dict(seeded_model.state_dict())
    program = load_exported(export_program(model.eval(), example_hw=(64, 64),
                                           device=cuda)).module()
    live = fold_bn(model, torch.bfloat16).to(cuda)
    live.compute_dtype = torch.bfloat16
    for hw in ((64, 64), (96, 160)):
        x = torch.from_numpy(smooth_images(72, 2, max(hw))[:, :hw[0], :hw[1], None]).to(cuda)
        before = (K.conv3x3_nhwc.launches, BR.bias_relu_nhwc.launches)
        with torch.no_grad():
            got = program(x)
        assert (K.conv3x3_nhwc.launches, BR.bias_relu_nhwc.launches) == (before[0] + 7,
                                                                         before[1] + 18)
        with torch.no_grad():
            want = live(x)
        torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


# -- the one-pass bias + ReLU of the folded 3x3 convs ------------------------------

# (B, H, W, C) of every folded conv output of unet_s and unet at 8 x 512²
BIAS_RELU_SHAPES = [(8, 512 >> i, 512 >> i, c) for widths in ((16, 32, 64, 128, 256),
                                                             (64, 128, 256, 512, 1024))
                    for i, c in enumerate(widths)]
BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


def _bias_relu_operands(shape, dtype, seed=0):
    """y and a bias on the card, with NaNs in both, -0.0 in both, and a pixel
    that the bias cancels exactly."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]
    y = torch.randn(shape, generator=g, device="cuda").to(dtype)
    b = torch.randn((c,), generator=g, device="cuda").to(dtype)
    y[0, 0, 0, 0] = float("nan")
    y[-1, -1, -1, -1] = -0.0
    y[0, 1, 1] = -b
    b[0] = y[0, 0, 1, 0] = -0.0  # a sum of -0.0
    b[c // 2] = float("nan")
    return y, b


def _bias_relu_check(y, b):
    before = BR.bias_relu_nhwc.launches
    got = BR.bias_relu_nhwc(y, b)
    want = torch.relu(y + b)
    torch.cuda.synchronize()
    assert BR.bias_relu_nhwc.launches == before + 1
    assert torch.equal(got.view(BITS[y.dtype]), want.view(BITS[y.dtype]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", BIAS_RELU_SHAPES + [(8, 64, 64, 12), (2, 33, 17, 6),
                                                      (2, 33, 17, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_bias_relu_kernel_equals_the_plain_pair(cuda, shape, dtype):
    """Bit for bit torch.relu(y + b) at every folded conv output of unet_s
    and unet at 8 x 512² (16-byte loop) and at C = 12, 6, 3 (the scalar
    loop where C is no multiple of 8 in bf16 or of 4 in f32)."""
    _bias_relu_check(*_bias_relu_operands(shape, dtype))


def test_bias_relu_kernel_at_the_tiled_window(cuda):
    """(8, 1216, 1216, 64) bf16: the tiled path's window, 1.5 GB, byte
    offsets past 2**31."""
    _bias_relu_check(*_bias_relu_operands((8, 1216, 1216, 64), torch.bfloat16))


def test_bias_relu_kernel_takes_a_misaligned_input(cuda):
    """A y that starts 2 bytes past a 16-byte boundary takes the scalar loop."""
    y, b = _bias_relu_operands((2, 16, 16, 64), torch.bfloat16)
    flat = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda)
    shifted = flat[1:].view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % 16
    _bias_relu_check(shifted, b)


def test_bias_relu_kernel_refuses_too_many_channels(cuda):
    """Past the 12288 f32 bias values a block stages in shared memory the C
    side returns cudaErrorInvalidValue, and the launch raises."""
    before = BR.bias_relu_nhwc.launches
    y = torch.zeros((1, 1, 2, 12289), device=cuda)
    with pytest.raises(RuntimeError, match="invalid argument"):
        BR.bias_relu_nhwc(y, torch.zeros((12289,), device=cuda))
    assert BR.bias_relu_nhwc.launches == before
    _bias_relu_check(*_bias_relu_operands((1, 2, 2, 12288), torch.float32))


def _parent_forward(self, x, compute_dtype=None, group=None, shard=None):
    """FoldedDoubleConv's forward before the one-pass epilogue."""
    kw = dict(padding=1, compute_dtype=compute_dtype, shard=shard)
    x = torch.relu(conv2d(x, self.w1, self.b1, **kw))
    return torch.relu(conv2d(x, self.w2, self.b2, **kw))


@pytest.mark.parametrize("name", ["unet_s", "unet"])
def test_served_class_maps_keep_their_bits(cuda, name):
    """Predictor.predict_array of unet_s and unet in bf16 on the benchmark's
    synthetic slices: 18 launches of the pass a forward, and class maps
    equal to those of a Predictor whose folded blocks run the parent's
    torch.relu(conv2d(...))."""
    import json
    import types
    from pathlib import Path

    from portbench.traffic import synth_slices

    spec = json.loads((Path(__file__).resolve().parent.parent / "portbench" / "traffic"
                       / "synth_slices.json").read_text())
    images = synth_slices(spec, 8, 2**31 + 17, cuda)[0].cpu().numpy()
    model = seeded_family(name, MODEL_SEED)
    pred = Predictor(model, device=cuda, compute_dtype=torch.bfloat16)
    ref = Predictor(model, device=cuda, compute_dtype=torch.bfloat16)
    for m in ref.model.modules():
        if isinstance(m, FoldedDoubleConv):
            m.forward = types.MethodType(_parent_forward, m)
    before = BR.bias_relu_nhwc.launches
    got = pred.predict_array(images)
    assert BR.bias_relu_nhwc.launches == before + 18
    want = ref.predict_array(images)
    assert BR.bias_relu_nhwc.launches == before + 18
    assert got.shape == want.shape == (8, 512, 512)
    assert np.array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_train_step_launches_no_bias_relu(cuda):
    """Training runs DoubleConv with live BN: the pass is not launched."""
    model = seeded_unet_s(torch.bfloat16).to(cuda)
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=1e-4))
    before = BR.bias_relu_nhwc.launches
    step(_rect_batch(cuda), 1e-4)
    torch.cuda.synchronize()
    assert BR.bias_relu_nhwc.launches == before


# -- UNet++ and YOLOv8-seg on the card -------------------------------------------

# name, get_model kwargs, routed 3x3 convs a forward
FAMILIES = [("unet_pp_s", dict(n_classes=3), 12), ("yolov8_seg_s", {}, 4)]


@pytest.mark.parametrize("name,kw,per_forward", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_predictor_on_card_matches_cpu(cuda, name, kw, per_forward):
    """f32 (TF32 off): the card's masks equal the CPU's on >= 99.9% of
    pixels, through per_forward kernel launches (YOLO serves live BN)."""
    model = seeded_family(name, MODEL_SEED, **kw)
    images = smooth_images(64, 2, 128)[:, :, :96]
    before = K.conv3x3_nhwc.launches
    with exact_f32():
        got = Predictor(model, device=cuda).predict_array(images)
    assert K.conv3x3_nhwc.launches == before + per_forward
    want = Predictor(model, device="cpu").predict_array(images)
    assert got.shape == want.shape == (2, 128, 96)
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("name,kw,per_forward", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_train_step_on_card_matches_cpu(cuda, name, kw, per_forward):
    """One f32 step (TF32 off), multiclass for UNet++ and binary for YOLO,
    with the bounds of test_train_step_on_card_matches_cpu; then in bf16
    each step launches the kernel per_forward times forward and as dx."""
    lr, n_classes = 1e-4, kw.get("n_classes", 1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = seeded_family(name, MODEL_SEED, centre=False, **kw).to(dev)
        step = make_train_step(model, LossConfig(n_classes=n_classes),
                               RMSpropConfig(learning_rate=lr))
        with exact_f32():
            metrics = step(_rect_batch(dev), lr)
        out[dev.type] = ({k: v.item() for k, v in metrics.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()})
    (m_card, g_card), (m_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert m_card["loss"] == pytest.approx(m_cpu["loss"], rel=1e-4)
    assert m_card["grad_norm"] == pytest.approx(m_cpu["grad_norm"], rel=1e-3)
    g_max = max(g.abs().max() for g in g_cpu.values())
    for n in g_cpu:
        assert (g_card[n] - g_cpu[n]).abs().max() <= 1e-3 * g_max, n

    model = seeded_family(name, MODEL_SEED, centre=False, compute_dtype=torch.bfloat16,
                          **kw).to(cuda)
    step = make_train_step(model, LossConfig(n_classes=n_classes),
                           RMSpropConfig(learning_rate=lr))
    before = _counts()
    metrics = step(_rect_batch(cuda), lr)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_counts(), before)] == [per_forward] * 4
    assert np.isfinite(metrics["loss"].item())


def test_unet_pp_int8_predictor_on_card_matches_cpu(cuda, tmp_path):
    """unet_pp_s int8 in f32 (TF32 off) on the card against the CPU on one
    calibration: masks >= 99.9% equal; all 30 DoubleConv convs ran int8."""
    model = seeded_family("unet_pp_s", MODEL_SEED, n_classes=3)
    images = smooth_images(65, 2, 128)[:, :, :96]
    with exact_f32():
        card = Predictor(model, device=cuda, quantize=True)
        card.calibrate(images)
        card.save_calibration(str(tmp_path / "s.json"))
        before = (K8.conv3x3_int8.launches, K.conv3x3_nhwc.launches)
        got = card.predict_array(images)
        assert (K8.conv3x3_int8.launches - before[0], K.conv3x3_nhwc.launches - before[1]) == (
            30, 0)
    cpu = Predictor(model, device="cpu", quantize=True)
    cpu.load_calibration(str(tmp_path / "s.json"))
    assert (got == cpu.predict_array(images)).mean() >= 0.999


@pytest.mark.parametrize("name,cin,cin2,cout,s", PP_SPLIT_CONVS,
                         ids=[c[0] for c in PP_SPLIT_CONVS])
def test_int8_kernel_at_unet_pp_split_shapes(cuda, name, cin, cin2, cout, s):
    """The nested conv1s' split inputs (the j skips, the upsample), exactly
    equal to the plain version."""
    x, wp, mul, badd = int8_operands(66, 2, 64 // s + 3, 96 // s + 5, cin + cin2, cout, cuda)
    x, x2 = x[..., :cin].contiguous(), x[..., cin:].contiguous()
    got = K8.conv3x3_int8(x, wp, mul, badd, torch.int8, x2)
    assert torch.equal(got, K8.conv3x3_int8_reference(x, wp, mul, badd, torch.int8, x2))


def test_yolo_exported_program_on_card(cuda):
    """yolov8_seg_s (bf16, live BN) as a program with symbolic H and W
    (multiples of 32): 4 launches a forward, masks >= 99.9% of the live
    Predictor's at two sizes."""
    from unet_medical_image_contour_segmentation_torch.engine.export import export_program
    from unet_medical_image_contour_segmentation_torch.engine.predict import ExportedPredictor

    model = seeded_family("yolov8_seg_s", MODEL_SEED)
    bf16 = seeded_family("yolov8_seg_s", MODEL_SEED, compute_dtype=torch.bfloat16)
    program = ExportedPredictor(export_program(bf16, device=cuda, example_hw=(128, 128)),
                                device=cuda)
    live = Predictor(model, device=cuda, compute_dtype=torch.bfloat16)
    for hw in ((128, 128), (96, 160)):
        images = smooth_images(67, 2, 160)[:, :hw[0], :hw[1]]
        before = K.conv3x3_nhwc.launches
        got = program.predict_array(images)
        assert K.conv3x3_nhwc.launches == before + 4
        assert (got == live.predict_array(images)).mean() >= 0.999


def test_dp_step_two_ranks_on_one_card(cuda):
    """chip_smoke's D2: two spawned ranks of 4 rows each on one card (gloo;
    NCCL refuses two ranks on one device) take one f32 step of the
    multiclass and of the binary criterion that matches one process's step
    on the 8 rows (chip_smoke.D2_TOL), 7 + 7 launches a rank."""
    launches, numbers = phase_dp_two_ranks()
    assert set(numbers) == {"nccl_two_ranks_one_device", "multiclass", "binary"}
    assert all(v["conv3x3_nhwc"] == v["conv3x3_nhwc_dx"] == 7 for v in launches.values())


def test_dp_serving_on_card(cuda):
    """chip_smoke's D3: two replicas on one card serve a ragged dense batch,
    a tiled 2048² scan and int8 with the single-device Predictor's masks,
    exactly."""
    launches, numbers = phase_dp_serve(build_model(MODEL_SEED))
    assert numbers["dense_agreement"] == numbers["tiled_agreement"] == \
        numbers["int8_agreement"] == 1.0
    assert launches["int8"]["conv3x3_int8"] == 36


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 1e-2)])
def test_halo_shape_launches_match_plain(cuda, dtype, tol):
    """chip_smoke's S1-S4 shapes: every rank's band plus its two halo rows
    at every level (chip_smoke.s_shapes), the forward and the dx kernel
    against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    for _, b, h, w, cin, cout, _ in s_shapes():
        x = torch.randn(b, h, w, cin, device=cuda, generator=gen).to(dtype)
        wt = (torch.randn(3, 3, cin, cout, device=cuda, generator=gen) / (3 * cin ** 0.5)).to(dtype)
        g = torch.randn(b, h, w, cout, device=cuda, generator=gen).to(dtype)
        with exact_f32():
            got, dx = K.conv3x3_nhwc(x, wt), K.conv3x3_nhwc_dx(g, wt)
            want = K.conv3x3_nhwc_reference(x, wt)
            want_dx = K.conv3x3_nhwc_reference(g, K.rotate_weight(wt))
            torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)


def test_spatial_step_two_ranks_on_one_card(cuda, tmp_path):
    """A row-sharded f32 step of the seeded unet_s at chip_smoke's S2 shape
    (2, 512, 512) on two spawned ranks on cuda:0 over gloo (a band of 256
    rows each) against one process's plain step (chip_smoke.S2_TOL), the
    ranks bit-equal, 7 + 7 launches a rank."""
    data = rect_batch(45, *S2_SHAPE)
    ranks = spawn_spatial(2, 1, [("S", "step", "unet_s", data, None, False)], str(tmp_path))
    diffs = s_check("S", ranks, s_plain_step("unet_s", data), s_want("unet_s", None), S2_TOL)
    assert diffs["loss"] <= S2_TOL["loss"]


def test_yolo_halo_ops_on_card_match_the_whole_image(cuda, tmp_path):
    """S5's equality in small: two spawned ranks on cuda:0 over gloo, a band
    of 8 rows each, run YOLOv8-seg's 3x3 stride-2 conv (one halo row above
    the band, no H padding; cuDNN) and its 5x5 SPPF pool (2 halo rows, -inf
    beyond the image, on an input negative there) in f32, forward and
    backward, against the whole-image ops on the card
    (tests/torch_spatial_ranks.py:check_halo: 1e-5)."""
    data = halo_data("cuda")
    ranks = run_ranks(spatial_cases, (1, 2, {"halo": ("halo", data)}), tmp_path, timeout=300)
    for name in ("conv_s2", "maxpool5"):
        check_halo(ranks, name, data)


@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
@pytest.mark.parametrize("zero", [True, False])
def test_prefetch_batches_equal_their_host_batches(cuda, device, zero):
    """chip_smoke's prefetch gate on 8 batches of (8, 512, 512, 1) f32 and
    their int32 masks: the copies run on a side stream, and every yielded
    batch equals its host batch, also when the consumer zeroes and drops
    it behind a queued busy-wait (the memory must not go to a later copy
    before that work has run)."""
    host = prefetch_host_batches(14, 8)
    bad, seen, _ = prefetch_gate(host, device, int(PREFETCH_BUSY_S * SLEEP_HZ), zero)
    assert (bad, seen) == (0, 8)


def test_async_checkpoint_of_a_card_model_is_its_state_at_the_call(cuda, tmp_path):
    """A step taken on the card once save_checkpoint_async has returned does
    not reach the file: it equals a synchronous save made before the step."""
    model = seeded_unet_s(torch.bfloat16).cuda()
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=1e-4))
    batch = {k: torch.from_numpy(v).cuda() for k, v in rect_batch(46, 2, 64, 64).items()}
    step(batch, 1e-4)
    save_checkpoint(str(tmp_path / "pre.npz"), model, step=1, optimizer=step.optimizer)
    fut = save_checkpoint_async(str(tmp_path / "async.npz"), model, step=1,
                                optimizer=step.optimizer)
    step(batch, 1e-4)
    fut.result(timeout=120)
    assert npz_differences(str(tmp_path / "pre.npz"), str(tmp_path / "async.npz")) == []


# -- TransUNet on the card --------------------------------------------------------


def test_transunet_served_forward(cuda, monkeypatch):
    """TransUNet R50-ViT-B/16 served at 512² in bf16 on one of the benchmark's
    synthetic slices: a forward runs 12 attentions on the pinned backend, 52
    GroupNorms, 9 bias + ReLU passes, no BatchNorm and no weight
    standardisation, and its classes lie within the benchmark cell's
    ``mean_logit_gap`` limit of the plain f32 reference's logits."""
    import json
    from pathlib import Path

    from portbench.reference import transunet as R
    from portbench.traffic import synth_slices
    from unet_medical_image_contour_segmentation_torch.models import blocks
    from unet_medical_image_contour_segmentation_torch.models.unet import get_model
    from unet_medical_image_contour_segmentation_torch.ops import vit

    root = Path(__file__).resolve().parent.parent / "portbench"
    spec = json.loads((root / "traffic" / "synth_slices.json").read_text())
    cfg = {"model": "transunet_r50_b16", "n_channels": 1, "n_classes": 3}
    images = synth_slices(spec, 4, 2**31 + 19, cuda)[0]
    sd = R.make_state_dict(cfg, torch.Generator(cuda).manual_seed(19), cuda)
    R.calibrate_bn(sd, cfg, R.normalize_uint8(images))
    model = get_model("transunet_r50_b16", n_channels=1, n_classes=3, bilinear=True,
                      compute_dtype=torch.bfloat16)
    model.load_state_dict(sd, strict=True)
    pred = Predictor(model, device=cuda, batch_size=1)
    host = images[:1].cpu().numpy()
    pred.predict_array(host)
    bns = []
    bn = blocks.batch_norm
    monkeypatch.setattr(blocks, "batch_norm", lambda *a, **k: bns.append(1) or bn(*a, **k))
    attn = dict(vit.attention.calls_by_backend)
    gn, std, br = vit.group_norm.calls, vit.standardize_weight.calls, BR.bias_relu_nhwc.launches
    got = pred.predict_array(host)
    torch.cuda.synchronize()
    calls = {k: v - attn.get(k, 0) for k, v in vit.attention.calls_by_backend.items()}
    assert {k: v for k, v in calls.items() if v} == {vit.PINNED: 12}
    assert vit.group_norm.calls - gn == 52 and BR.bias_relu_nhwc.launches - br == 9
    assert vit.standardize_weight.calls == std and not bns
    with torch.no_grad(), R.no_tf32():
        logits = R.forward(sd, cfg, R.normalize_uint8(images[:1]))[0]
    c = torch.from_numpy(got[0]).to(cuda).long()
    gap = logits.max(dim=-1).values - logits.gather(-1, c.unsqueeze(-1)).squeeze(-1)
    limits = json.loads((root / "workloads" / "transunet_r50_b16.serve_batch.json").read_text())
    assert float(gap.mean()) <= limits["limits"]["mean_logit_gap"]
    assert len(np.unique(got)) > 1


def test_upsample_matrices_are_copied_to_the_card_once(cuda):
    """The x2 upsample's interpolation matrices are copied to the card once
    and reused (a copy from host memory each call waits for the stream):
    served under inference mode first, they still train, and the cached
    matrix is the host one."""
    from unet_medical_image_contour_segmentation_torch.models.unet import get_model
    from unet_medical_image_contour_segmentation_torch.ops import resize

    torch.manual_seed(5)
    model = get_model("transunet_tiny", n_channels=1, n_classes=3, bilinear=True,
                      dropout=0.0).to(cuda)
    x = torch.rand(2, 64, 64, 1)
    resize._interp_matrix_on_card.cache_clear()
    pred = Predictor(model, device=cuda, batch_size=2)
    first = pred.predict_array((x[..., 0] * 255).to(torch.uint8).numpy())
    misses = resize._interp_matrix_on_card.cache_info().misses
    assert misses == 4  # 4 -> 8 -> 16 -> 32 -> 64, one matrix per size and axis
    assert np.array_equal(pred.predict_array((x[..., 0] * 255).to(torch.uint8).numpy()), first)
    assert resize._interp_matrix_on_card.cache_info().misses == misses
    step = make_train_step(model.train(), LossConfig(n_classes=3),
                           RMSpropConfig(learning_rate=1e-4))
    metrics = step({"image": x.to(cuda), "mask": torch.randint(0, 3, (2, 64, 64), device=cuda)},
                   1e-4)
    assert np.isfinite(float(metrics["loss"]))
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())
    got = resize._interp_matrix(8, 16, True, cuda)
    assert got.device.type == "cuda" and not got.is_inference()
    assert resize._interp_matrix_on_card.cache_info().misses == misses  # cuda is cuda:0
    assert torch.equal(got.cpu(), torch.from_numpy(resize._interp_matrix_np(8, 16, True)))
