"""The int8 kernel's launch geometry (pure Python, as ``csrc/conv3x3_int8.cu``
computes it) and its split input, on the CPU: every output pixel and channel
is covered once, shared memory fits at every shape the paths give the
kernel, and the split input's plain version equals the concatenated one."""

import numpy as np
import pytest
import torch

from chip_smoke import INT8_CONVS, int8_operands, random_unet_params
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3_int8 as K8
from unet_medical_image_contour_segmentation_torch.models import quantize as TQ
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s

SM_BYTES = 233_472         # shared memory of one SM; each resident block reserves 1 KiB more
UNET = (64, 128, 256, 512, 1024)
UNET_S = (16, 32, 64, 128, 256)


def _convs(widths):
    """(Cin, Cout, Cin2, downsampling) of a UNet's 18 3x3 convs, each Up's
    conv1 as a split (skip, upsample) input."""
    w = widths
    out = [(1, w[0], 0, 1), (w[0], w[0], 0, 1)]
    for i in range(1, 5):
        out += [(w[i - 1], w[i], 0, 2 ** i), (w[i], w[i], 0, 2 ** i)]
    for i in range(1, 5):
        skip, s = w[4 - i], 2 ** (4 - i)
        out += [(skip, skip, skip, s), (skip, skip, 0, s)]
    return out


def _tiles(geo, h, w):
    """(b, h0, w0, n0) of each tile, decoded as the kernel's tile_at."""
    rows, cols = geo.tile
    tiles_h, tiles_w = -(-h // rows), -(-w // cols)
    for t in range(geo.n_tiles):
        n0 = t % geo.n_pieces * 256
        t //= geo.n_pieces
        w0 = t % tiles_w * cols
        t //= tiles_w
        yield t // tiles_h, t % tiles_h * rows, w0, n0


@pytest.mark.parametrize("b,h,w,cin,cout,cin2", [
    (2, 37, 53, 1, 16, 0), (1, 37, 53, 8, 8, 0), (1, 5, 3, 16, 1, 0), (3, 9, 70, 48, 72, 0),
    (1, 32, 32, 1024, 512, 0), (2, 64, 64, 16, 16, 16), (2, 44, 44, 256, 256, 0),
    (1, 88, 88, 64, 128, 64), (2, 33, 130, 32, 300, 0), (8, 64, 64, 64, 128, 0),
])
def test_int8_geometry_covers_every_output_once(b, h, w, cin, cout, cin2):
    """The tiles, each cut at the image edge and at Cout, cover every output
    pixel and channel once; each persistent block keeps one Cout piece."""
    geo = K8.launch_geometry(b, h, w, cin, cout, cin2)
    rows, cols = geo.tile
    seen = np.zeros((b, h, w, cout), np.int32)
    for bi, h0, w0, n0 in _tiles(geo, h, w):
        seen[bi, h0:h0 + rows, w0:w0 + cols, n0:n0 + geo.n] += 1
    assert (seen == 1).all()
    assert geo.n >= min(cout, 256) and geo.n_pieces * min(geo.n, 256) >= cout
    assert geo.grid % geo.n_pieces == 0 and geo.grid <= max(geo.n_tiles, geo.n_pieces)
    assert geo.grid <= K8.H100_SMS * geo.blocks_per_sm
    for block in range(geo.grid):
        assert len({t % geo.n_pieces for t in range(block, geo.n_tiles, geo.grid)}) <= 1
    assert geo.route == ("im2col" if cin < 16 and not cin2 else "tma")


def _shapes():
    """(b, h, w, cin, cout, cin2) of every int8 conv that unet_s and the full
    unet give the kernel: dense 512² at b = 1..16, the tiled windows of 704²
    and 1216², and the edge shapes of tests/test_torch_gpu.py."""
    out = []
    for widths in (UNET_S, UNET):
        for b, size in ((1, 512), (8, 512), (16, 512), (16, 704), (8, 1216)):
            out += [(b, size // s, size // s, cin, cout, cin2)
                    for cin, cout, cin2, s in _convs(widths)]
    edges = [((2, 37, 53), 1, 16), ((1, 37, 53), 32, 40), ((1, 32, 32), 1024, 512),
             ((3, 9, 70), 48, 72), ((1, 5, 3), 16, 1), ((1, 37, 53), 8, 8)]
    return out + [(*shape, cin, cout, 0) for shape, cin, cout in edges]


def test_int8_geometry_fits_shared_memory():
    """Every shape of the paths fits a block's 232,448 bytes, and the blocks
    an SM each kernel is built for fit the SM; so does any Cout up to 1024
    at Cin < 16."""
    for shape in _shapes():
        geo = K8.launch_geometry(*shape)
        assert geo.smem_bytes <= K8.SMEM_MAX == 232_448, (shape, geo)
        assert geo.blocks_per_sm * (geo.smem_bytes + 1024) <= SM_BYTES, (shape, geo)
    for cin in range(1, 16):
        for cout in (1, 8, 16, 17, 40, 64, 100, 128, 200, 256, 1024):
            geo = K8.launch_geometry(1, 8, 8, cin, cout)
            assert geo.blocks_per_sm * (geo.smem_bytes + 1024) <= SM_BYTES, (cin, cout, geo)


@pytest.mark.parametrize("cin,cout,cin2,smem,stages", [
    (16, 16, 0, 57_152, 2),     # 2 x (2 planes of 10x66x16 B at 128 B + 18 x 16 x 16 B) + 5,440
    (32, 32, 0, 208_320, 4),    # 4 x (2 x 19,072 + 18 x 32 x 16) + 18,880: one block an SM
    (256, 256, 0, 201_408, 2),  # 2 x (2 x 4,224 + 18 x 256 x 16) + 37,056
    (64, 128, 64, 185_024, 3),  # 3 x (2 x 6,400 + 18 x 128 x 16) + 36,032
    (1, 16, 0, 23_136, 1),      # im2col: 8x64x32 A + 32x16 B + 128 taps + 10x66 halo + 5,440
])
def test_int8_geometry_shared_memory_by_hand(cin, cout, cin2, smem, stages):
    geo = K8.launch_geometry(8, 64, 64, cin, cout, cin2)
    assert (geo.smem_bytes, geo.stages) == (smem, stages)


def test_int8_geometry_of_the_main_path():
    """unet_s at (8, 512²): a persistent grid of three blocks per SM at N =
    16 (four for the im2col kernel), else one, which at the deep levels
    takes one tile of 2 or 4 rows."""
    for name, cin, cout, s, _ in INT8_CONVS:
        geo = K8.launch_geometry(8, 512 // s, 512 // s, cin, cout)
        per_sm = (4 if cin < 16 else 3) if cout <= 16 else 1
        assert geo.blocks_per_sm == per_sm, name
        assert geo.grid == min(geo.n_tiles, 132 * per_sm), name
        assert geo.tile == ({256: 2, 128: 4, 64: 8, 32: 16}.get(geo.n, 8), 64), name


@pytest.mark.parametrize("cin,cout", [(1, 16), (16, 1), (40, 300), (64, 128)])
def test_pack_weight_is_the_staging_order(cin, cout):
    """Element [p, c, t, j, n, e] is w[t // 3, t % 3, 32 c + 16 j + e, 256 p + n],
    zeros past Cin and Cout, so each (piece, chunk) is one contiguous run of
    288 * rows bytes; weight_matrix gives back the (Cout, 9 * Cin_p) matrix."""
    w = torch.from_numpy(np.random.default_rng(cin).integers(-127, 128, (3, 3, cin, cout),
                                                              dtype=np.int8))
    wp = K8.pack_weight(w)
    rows, cin_p = min(cout, 256), -(-cin // 32) * 32
    assert tuple(wp.shape) == (-(-cout // rows), cin_p // 32, 9, 2, rows, 16)
    full = torch.zeros((3, 3, cin_p, wp.shape[0] * rows), dtype=torch.int8)
    full[:, :, :cin, :cout] = w
    p, c, t, j, n, e = np.ix_(*[np.arange(d) for d in wp.shape])
    want = full.numpy()[t // 3, t % 3, 32 * c + 16 * j + e, rows * p + n]
    np.testing.assert_array_equal(wp.numpy(), want)
    mat = K8.weight_matrix(wp, cout)
    np.testing.assert_array_equal(mat.numpy(), full[..., :cout].reshape(9, cin_p, cout)
                                  .permute(2, 0, 1).reshape(cout, -1).numpy())


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c1,c2", [(16, 16), (8, 8), (32, 64), (24, 40)])
def test_split_input_equals_the_concatenation(c1, c2, out_dtype):
    """x2 is summed as the channels after x's, exactly as one conv on the
    concatenation; the wrapper's CPU path is that plain version."""
    x, wp, mul, badd = int8_operands(80 + c1, 2, 9, 13, c1 + c2, 24, "cpu")
    parts = x[..., :c1].contiguous(), x[..., c1:].contiguous()
    want = K8.conv3x3_int8_reference(x, wp, mul, badd, out_dtype)
    got = K8.conv3x3_int8_reference(*parts[:1], wp, mul, badd, out_dtype, x2=parts[1])
    assert torch.equal(got, want)
    assert torch.equal(K8.conv3x3_int8(parts[0], wp, mul, badd, out_dtype, x2=parts[1]), want)


def test_split_input_is_checked():
    x, wp, mul, badd = int8_operands(90, 1, 8, 8, 32, 16, "cpu")
    with pytest.raises(ValueError, match="differ"):
        K8.conv3x3_int8(x[..., :16].contiguous(), wp, mul, badd, x2=x[:, :4, :, 16:].contiguous())
    with pytest.raises(ValueError, match="pack_weight"):  # Cin 16 + 48 against a 32 pack
        K8.conv3x3_int8(x[..., :16].contiguous(), wp, mul, badd,
                        x2=torch.zeros((1, 8, 8, 48), dtype=torch.int8))
    with pytest.raises(ValueError, match="x2"):
        K8.conv3x3_int8(x[..., :16].contiguous(), wp, mul, badd, x2=x[..., 16:].float())


def test_int8_forward_feeds_each_up_conv1_a_split_input(monkeypatch):
    """apply_int8 hands every Up's conv1 its int8 skip and upsample apart
    (4 of the 18 convs) and concatenates nothing; the logits equal those of
    a walker that concatenates first."""
    params, state = random_unet_params(5)
    model = unet_s()
    model.load_state_dict(state_dict_from_jax(params, state))
    images = np.random.default_rng(6).random((2, 32, 32), dtype=np.float32)
    pred = Predictor(model, device="cpu", quantize=True)
    pred.calibrate(images)
    calls, conv = [], K8.conv3x3_int8

    def split(x, wp, mul, badd, out_dtype=torch.int8, x2=None):
        calls.append(x2 is not None)
        return conv(x, wp, mul, badd, out_dtype, x2)

    def concatenated(x, wp, mul, badd, out_dtype=torch.int8, x2=None):
        return conv(x if x2 is None else torch.cat([x, x2], dim=-1), wp, mul, badd, out_dtype)

    monkeypatch.setattr(TQ, "conv3x3_int8", split)
    got = TQ.apply_int8(pred._qparams, torch.from_numpy(images))
    assert calls == [False] * 10 + [True, False] * 4
    monkeypatch.setattr(TQ, "conv3x3_int8", concatenated)
    assert torch.equal(got, TQ.apply_int8(pred._qparams, torch.from_numpy(images)))
