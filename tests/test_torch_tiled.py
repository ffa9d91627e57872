"""The port's tiled Predictor against the JAX package's, f32 on the CPU.

Weights are chip_smoke's seeded numpy pytrees (BN biases and running means
off zero, so a zero-padded image and a zero-padded activation differ) with
the head bias centred so the classes split the pixels
(``chip_smoke.build_model``); they cross over with ``params_from_state_dict``.
Masks must be equal except where the top-two logit margin of the port's f32
window forward is below MARGIN = 1e-4 (there the summation order of two
frameworks may decide).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import build_model, tiled_logits, top2_margin
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.kernels.conv3x3 import (
    _GRID_MAX,
    launch_geometry,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
)
from unet_medical_image_contour_segmentation_torch.models import unet_s as unet_s_preset
from unet_medical_image_contour_segmentation_torch.models import unet_t as unet_t_preset
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.models.unet import UNet as JaxUNet

MARGIN = 1e-4
UNET_T = (8, 16, 32, 64, 128)
UNET_S = (16, 32, 64, 128, 256)
TILE, HALO = 64, 48


def seeded(seed, factory):
    """(params, state, port model): chip_smoke's seeded weights, the head
    bias centred on a noise probe."""
    model = build_model(seed, factory)
    params, state, _ = params_from_state_dict(model.state_dict())
    return params, state, model


@pytest.fixture(scope="module")
def unet_t():
    return seeded(11, unet_t_preset)


def jax_predictor(params, state, widths, **kw):
    params, state = jax.tree.map(jnp.asarray, (params, state))
    return JaxPredictor(JaxUNet(1, 3, widths=widths), params, state, **kw)


def normalised(images):
    x = images.astype(np.float32)
    if images.dtype == np.uint8:
        mx = x.reshape(len(x), -1).max(axis=1).reshape(-1, 1, 1, 1)
        x = np.where(mx > 1, x / np.float32(255.0), x)
    return x if x.ndim == 4 else x[..., None]


def tiled_margin(port, images, tile, halo):
    """Top-two margin of the stitched logits of the port's f32 window forward
    (a plain loop over the tiles, the reference of the tiled paths)."""
    x = torch.from_numpy(normalised(images))
    return top2_margin(tiled_logits(port.model, x, tile, halo)).numpy()


def images_of(hw, dtype, seed, n=2):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, *hw, 1), dtype=np.uint8)
    return rng.random((n, *hw, 1), dtype=np.float32)


def assert_split(masks):
    """The classes split the pixels, so equality is no accident of a constant map."""
    shares = np.bincount(masks.ravel(), minlength=3) / masks.size
    assert (shares > 0.05).sum() >= 2, shares


def test_above_threshold_matches_jax_not_dense(unet_t):
    """An image above tile_threshold is served tiled, as the JAX Predictor
    serves it; the dense forward is another function near the border (the
    port served it dense before it had tiling)."""
    params, state, model = unet_t
    images = images_of((160, 224), np.float32, 1, n=1)
    port = Predictor(model, device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=96 * 96)
    got = port.predict_array(images)
    want = np.asarray(jax_predictor(params, state, UNET_T, tile=TILE, tile_halo=HALO,
                                    tile_threshold=96 * 96).predict_array(images))
    assert got.shape == want.shape == (1, 160, 224) and got.dtype == np.int32
    assert_split(want)
    ok = tiled_margin(port, images, TILE, HALO) >= MARGIN
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])
    dense = Predictor(model, device="cpu", tile_threshold=0).predict_array(images)
    assert (dense != want).mean() > 0.01


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["float", "uint8"])
@pytest.mark.parametrize("hw", [(160, 224), (97, 131), (65, 193), (64, 64)])
def test_tiled_matches_jax(unet_t, hw, dtype):
    params, state, model = unet_t
    images = images_of(hw, dtype, hw[0])
    port = Predictor(model, device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=1)
    got = port.predict_array(images)
    want = np.asarray(jax_predictor(params, state, UNET_T, tile=TILE, tile_halo=HALO,
                                    tile_threshold=1).predict_array(images))
    assert got.shape == want.shape == (2, *hw) and got.dtype == np.int32
    ok = tiled_margin(port, images, TILE, HALO) >= MARGIN
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])


def test_uint8_tiles_like_its_normalised_float(unet_t):
    model = unet_t[2]
    u8 = images_of((97, 131), np.uint8, 3)
    port = Predictor(model, device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=1)
    np.testing.assert_array_equal(port.predict_array(u8), port.predict_array(normalised(u8)))
    ones = np.ones((1, 80, 80), np.uint8)  # max 1: not divided
    np.testing.assert_array_equal(port.predict_array(ones),
                                  port.predict_array(ones.astype(np.float32)))


@pytest.fixture(scope="module")
def unet_s():
    return seeded(12, unet_s_preset)


def test_border_semantics_match_jax(unet_s):
    """unet_s at halo 96 (its receptive field): tiled equals dense in the
    interior, seams included, and differs from it only within a halo of the
    border, because the tiled forward zero-pads the image and the dense one
    every activation; the JAX package does the same."""
    params, state, model = unet_s
    tile, halo, hw = 160, 96, (320, 320)  # 2 x 2 windows of 352²
    images = images_of(hw, np.float32, 5, n=1)
    tiled = Predictor(model, device="cpu", tile=tile, tile_halo=halo, tile_threshold=1)
    dense = Predictor(model, device="cpu", tile_threshold=0)
    got_t, got_d = tiled.predict_array(images), dense.predict_array(images)
    jt = jax_predictor(params, state, UNET_S, tile=tile, tile_halo=halo, tile_threshold=1)
    jd = jax_predictor(params, state, UNET_S, tile_threshold=0)
    want_t = np.asarray(jt.predict_array(images))
    want_d = np.asarray(jd.predict_array(images))
    border = np.ones(hw, bool)
    border[halo:-halo, halo:-halo] = False
    ok = tiled_margin(tiled, images, tile, halo)[0] >= MARGIN
    for t, d in ((got_t[0], got_d[0]), (want_t[0], want_d[0])):
        np.testing.assert_array_equal(t[~border & ok], d[~border & ok])
        assert (t[border] != d[border]).mean() > 0.01
    np.testing.assert_array_equal(got_t[0][ok], want_t[0][ok])


def test_auto_tile_rule(unet_t):
    """The same numbers as the JAX package's tests/test_pipeline.py."""
    p = Predictor(unet_t[2], device="cpu")
    assert p.tile is None and p.tile_halo == 96 and p.tile_threshold == 1536 * 1536
    assert (p.TILE_THRESHOLD, p.tile_batch, p.AUTO_TILES, p.AUTO_TILE_MIN_TILES,
            p.tile_on_device) == (1536 * 1536, 8, (512, 1024), 8, True)
    assert p._auto_tile(4096, 4096) == 1024
    assert p._auto_tile(3072, 3072) == 1024
    assert p._auto_tile(2048, 2048) == 512
    assert p._auto_tile(1600, 1600) == 512
    assert p._auto_tile(1024, 8192) == 1024


def test_use_tiling_rule(unet_t):
    p = Predictor(unet_t[2], device="cpu", tile_threshold=100)
    assert p._use_tiling((10, 11), (10, 11)) and not p._use_tiling((10, 10), (10, 10))
    assert not p._use_tiling((10, 11), (20, 22))  # a back-resize stays dense
    assert not Predictor(unet_t[2], device="cpu", tile_threshold=0)._use_tiling(
        (4096, 4096), (4096, 4096))


def test_auto_tile_end_to_end(unet_t):
    """tile=None picks per image; shrunk candidates exercise both choices."""
    params, state, model = unet_t
    port = Predictor(model, device="cpu", tile_halo=HALO, tile_threshold=1)
    jp = jax_predictor(params, state, UNET_T, tile_halo=HALO, tile_threshold=1)
    for p in (port, jp):
        p.AUTO_TILES, p.AUTO_TILE_MIN_TILES = (64, 96), 4
    for hw, tile in (((192, 192), 96), ((96, 160), 64)):
        assert port._auto_tile(*hw) == tile
        images = images_of(hw, np.float32, 7, n=1)
        got, want = port.predict_array(images), np.asarray(jp.predict_array(images))
        ok = tiled_margin(port, images, tile, HALO) >= MARGIN
        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.fixture(scope="module")
def stitched(unet_t):
    """Float and uint8 images of 2 x 3 tiles with their host-stitched masks
    (one forward per tile) and the float images' decided pixels."""
    host = Predictor(unet_t[2], device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=1)
    host.tile_on_device = False
    images = images_of((128, 192), np.float32, 8)
    u8 = images_of((97, 131), np.uint8, 9)
    ok = tiled_margin(host, images, TILE, HALO) >= MARGIN
    return images, host.predict_array(images), ok, u8, host.predict_array(u8)


@pytest.mark.parametrize("tile_batch", [1, 4, 8])
def test_device_grid_matches_host_stitching(unet_t, stitched, tile_batch):
    """Any group size gives the host-stitched map: one tile a forward, two
    groups of 4 (the last padded with duplicates of the last tile, which
    rewrite its core with the same classes), and 8 clamped to the 6 tiles."""
    images, want, ok, u8, want_u8 = stitched
    grid = Predictor(unet_t[2], device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=1)
    grid.tile_batch = tile_batch
    np.testing.assert_array_equal(grid.predict_array(images)[ok], want[ok])
    np.testing.assert_array_equal(grid.predict_array(u8), want_u8)


def test_predict_paths_tiles_large_files(unet_t, tmp_path):
    params, state, model = unet_t
    rng = np.random.default_rng(10)
    files = []
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.integers(0, 256, (160, 224), dtype=np.uint8)).save(tmp_path / name)
        files.append(str(tmp_path / name))
    port = Predictor(model, device="cpu", tile=TILE, tile_halo=HALO, tile_threshold=96 * 96)
    jp = jax_predictor(params, state, UNET_T, tile=TILE, tile_halo=HALO,
                       tile_threshold=96 * 96)
    images = np.stack([np.asarray(Image.open(f)) for f in files])[..., None]
    tiled = port.predict_array(images)
    ok = tiled_margin(port, images, TILE, HALO) >= MARGIN
    for fast in (False, True):
        got = port.predict_paths(files, postprocess=False, save=False, fast_transfer=fast)
        want = jp.predict_paths(files, postprocess=False, save=False, fast_transfer=fast)
        for k, f in enumerate(files):
            assert got[f].dtype == np.int32
            np.testing.assert_array_equal(got[f], tiled[k])
            np.testing.assert_array_equal(got[f][ok[k]], np.asarray(want[f])[ok[k]])


@pytest.mark.parametrize("n,hw,tile", [(2, (2048, 2048), 512), (1, (4096, 4096), 1024),
                                       (1, (4096, 4096), 512)])
def test_window_batches_fit_the_launch_grid(n, hw, tile):
    """The tiled unet_s forwards of chip_smoke give the 3x3 kernel tpb * n
    windows of tile + 192 pixels and their halves and quarters; each launch
    fits the grid (the wrapper raises where it would not)."""
    tpb = min(Predictor.tile_batch, (hw[0] // tile) * (hw[1] // tile))
    win = tile + 2 * 96
    for s, cin, cout in ((1, 16, 16), (2, 16, 32), (2, 32, 32), (4, 32, 64), (1, 32, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            geo = launch_geometry(tpb * n, win // s, win // s, cin, cout, dtype)
            assert max(geo.grid[1:]) <= _GRID_MAX, geo
