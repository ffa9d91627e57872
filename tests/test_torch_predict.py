"""The port's dense Predictor against the JAX package's, on the same weights;
f32 on the CPU.  Class maps must be equal wherever the JAX logits' top-2
margin is at least 1e-4 (below that, summation order may decide)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch import resolve_device
from unet_medical_image_contour_segmentation_torch.cli import predict as cli
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import save_checkpoint
from unet_medical_image_contour_segmentation_torch.engine import predict as P
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    Predictor,
    collect_image_files,
    mask_to_image,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s as torch_unet_s
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.losses.s2d_fused import argmax_class_major
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_s as jax_unet_s
from unet_medical_image_contour_segmentation_tpu.ops.resize import bilinear_resize

MARGIN = 1e-4


@pytest.fixture(scope="module")
def weights():
    return random_unet_params(2)


@pytest.fixture(scope="module")
def model(weights):
    m = torch_unet_s()
    m.load_state_dict(state_dict_from_jax(*weights))
    return m


@pytest.fixture(scope="module")
def port(model):
    return Predictor(model, device="cpu")


@pytest.fixture(scope="module")
def jax_pred(weights):
    params, state = jax.tree.map(jnp.asarray, weights)
    return JaxPredictor(jax_unet_s(1, 3), params, state)


def decided(weights, images, out_hw):
    """Pixels whose JAX top-2 logit margin is at least MARGIN."""
    params, state = weights
    x = images.astype(np.float32) / (255.0 if images.dtype == np.uint8 else 1.0)
    logits, _ = jax_unet_s(1, 3, layout="nhwc").apply(params, state, jnp.asarray(x), train=False)
    logits = np.asarray(bilinear_resize(logits, *out_hw, align_corners=False))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] >= MARGIN


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), None), ((48, 80), (60, 100))])
def test_predict_array_matches_jax(weights, port, jax_pred, in_hw, out_hw):
    images = np.random.default_rng(3).random((2, *in_hw, 1), dtype=np.float32)
    got = port.predict_array(images, out_hw)
    want = np.asarray(jax_pred.predict_array(images, out_hw))
    assert got.shape == want.shape == (2, *(out_hw or in_hw)) and got.dtype == np.int32
    ok = decided(weights, images, out_hw or in_hw)
    assert ok.mean() > 0.99
    np.testing.assert_array_equal(got[ok], want[ok])


def test_uint8_input(weights, port, jax_pred):
    u8 = np.random.default_rng(4).integers(0, 256, (2, 64, 64), dtype=np.uint8)
    got = port.predict_array(u8)
    # device normalisation equals the host's: /255 when the image's max > 1
    np.testing.assert_array_equal(got, port.predict_array(u8.astype(np.float32) / 255.0))
    ok = decided(weights, u8[..., None], (64, 64))
    np.testing.assert_array_equal(got[ok], np.asarray(jax_pred.predict_array(u8))[ok])
    # an image already in [0, 1] is not divided
    ones = np.ones((1, 32, 32), np.uint8)
    np.testing.assert_array_equal(port.predict_array(ones),
                                  port.predict_array(ones.astype(np.float32)))


def test_batches_larger_than_batch_size(model):
    images = np.random.default_rng(5).random((5, 32, 32), dtype=np.float32)
    small = Predictor(model, device="cpu", batch_size=2).predict_array(images)
    np.testing.assert_array_equal(small, Predictor(model, device="cpu").predict_array(images))


def _chunked_maps(pred, images):
    """predict_array's route before the uint8 maps and the one result
    array: each chunk's map copied to the host by ``.cpu()``, then
    concatenated."""
    n, bs = len(images), pred.batch_size
    return np.concatenate([pred._predict_device(images[i:i + bs], None, n).cpu().numpy()
                           for i in range(0, n, bs)]).astype(np.int32)


@pytest.mark.parametrize("n_classes", [3, 1])
@pytest.mark.parametrize("n,batch_size", [(2, 8), (5, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_predict_array_widens_the_chunked_maps(n_classes, n, batch_size, dtype):
    torch.manual_seed(n_classes)
    pred = Predictor(torch_unet_s(n_classes=n_classes), device="cpu", batch_size=batch_size)
    rng = np.random.default_rng(n)
    images = (rng.integers(0, 256, (n, 32, 32), dtype=np.uint8) if dtype == np.uint8
              else rng.random((n, 32, 32), dtype=np.float32))
    before = P._fetch_classes.calls_by_route["host"]
    got = pred.predict_array(images)
    assert P._fetch_classes.calls_by_route["host"] == before + -(-n // batch_size)
    assert got.dtype == np.int32 and got.shape == (n, 32, 32)
    assert got.flags.owndata and got.flags.c_contiguous
    np.testing.assert_array_equal(got, _chunked_maps(pred, images))


@pytest.mark.parametrize("n_classes,dtype", [(1, torch.uint8), (3, torch.uint8),
                                             (256, torch.uint8), (257, torch.int32)])
def test_class_maps_are_uint8_up_to_256_classes(port, n_classes, dtype):
    logits = torch.randn((2, 8, 8, n_classes), generator=torch.Generator().manual_seed(9))
    got = port._classes(logits)
    assert got.dtype == dtype and got.shape == (2, 8, 8)
    want = logits[..., 0] > 0 if n_classes == 1 else logits.argmax(-1)
    assert torch.equal(got.long(), want.long())


def test_kept_outputs_are_not_overwritten(port):
    rng = np.random.default_rng(10)
    a, b = (rng.integers(0, 256, (3, 32, 32), dtype=np.uint8) for _ in range(2))
    first = port.predict_array(a)
    kept = first.copy()
    second = port.predict_array(b)
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    assert not np.array_equal(first, second)


@pytest.fixture
def png_dir(tmp_path):
    rng = np.random.default_rng(6)
    src = tmp_path / "in"
    (src / "sub").mkdir(parents=True)
    for name, hw in (("a.png", (64, 64)), ("b.png", (64, 64)), ("sub/c.png", (48, 80))):
        Image.fromarray(rng.integers(0, 256, hw, dtype=np.uint8)).save(src / name)
    (src / "notes.txt").write_text("not an image")
    return src


@pytest.mark.parametrize("fast_transfer", [False, True])
def test_predict_paths_matches_jax(port, jax_pred, png_dir, tmp_path, fast_transfer):
    files = collect_image_files(str(png_dir))
    assert [f[len(str(png_dir)) + 1:] for f in files] == ["a.png", "b.png", "sub/c.png"]
    got = port.predict_paths(files, output_dir=str(tmp_path / "port"), postprocess=True,
                             fast_transfer=fast_transfer)
    want = jax_pred.predict_paths(files, output_dir=str(tmp_path / "jax"), postprocess=True,
                                  fast_transfer=fast_transfer)
    assert sorted(got) == sorted(want) == files
    for f in files:
        assert got[f].shape == np.asarray(Image.open(f)).shape
        assert (got[f] != want[f]).mean() < 1e-3
        saved = np.asarray(Image.open(tmp_path / "port" / os.path.basename(f)))
        np.testing.assert_array_equal(saved, np.asarray(mask_to_image(got[f])))
        assert set(np.unique(saved)) <= {0, 128, 255}


def test_predict_image(port, png_dir):
    img = Image.open(png_dir / "sub" / "c.png").convert("L")
    raw = port.predict_image(img, postprocess=False)
    assert raw.shape == (48, 80)
    arr = np.asarray(img, np.float32)[None, ..., None] / 255.0
    np.testing.assert_array_equal(raw, port.predict_array(arr)[0])


@pytest.mark.parametrize("bias,want", [([0.5, 1.0, 1.0], 1), ([1.0, 1.0, 1.0], 0),
                                       ([0.0, 0.0, 2.0], 2)])
def test_first_max_wins_on_ties(bias, want):
    model = torch_unet_s()
    with torch.no_grad():
        model.outc.conv.weight.zero_()
        model.outc.conv.bias.copy_(torch.tensor(bias))
    images = np.random.default_rng(7).random((1, 32, 32), dtype=np.float32)
    assert (Predictor(model, device="cpu").predict_array(images) == want).all()


def test_argmax_tie_rule_matches_jax():
    logits = np.random.default_rng(8).integers(0, 2, (500, 3)).astype(np.float32)
    class_major = logits.T.reshape(1, -1)  # class c in lanes [c*500, (c+1)*500)
    want = np.asarray(argmax_class_major(jnp.asarray(class_major), 3))[0]
    np.testing.assert_array_equal(torch.from_numpy(logits).argmax(-1).numpy(), want)


def test_default_device_needs_a_card(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_predicts_a_directory(model, png_dir, tmp_path):
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, model)
    out = tmp_path / "masks"
    rc = cli.main(["-m", ck, "-i", str(png_dir), "-o", str(out), "--arch", "unet_s",
                   "--device", "cpu", "--no-postprocess"])
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == ["a.png", "b.png", "c.png"]
    want = Predictor(model, device="cpu").predict_paths(
        collect_image_files(str(png_dir)), postprocess=False, save=False)
    for path, mask in want.items():
        saved = np.asarray(Image.open(out / os.path.basename(path)))
        np.testing.assert_array_equal(saved, np.asarray(mask_to_image(mask)))


@pytest.mark.parametrize("extra", [["--num-devices", "0"], ["--model", "m.stablehlo"],
                                   ["--model", "m.stablehlo", "--arch", "yolov8_seg_s", "--int8"],
                                   ["--num-devices", "-2"],
                                   ["--num-devices", "0", "--int8", "--arch", "yolov8_seg_s"]])
def test_cli_rejects_what_is_not_ported(extra, capsys):
    """JAX's StableHLO programs, whatever the architecture and precision
    (YOLOv8-seg's --int8 serves: tests/test_torch_yolo_int8.py), and a
    device count below 1 (data-parallel serving: tests/test_torch_utils.py)."""
    with pytest.raises(SystemExit) as exc:
        cli.get_args(["-m", "w.npz", "-i", "x.png", *extra])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert extra[0] in err or "invalid choice" in err


def test_cli_int8_calibrates_saves_and_reloads(model, png_dir, tmp_path):
    """--int8 --int8-scales on the CPU: the first run calibrates on its first
    batch and writes the JSON, the second loads it; both write the masks of
    an int8 Predictor on that calibration."""
    ck, scales = str(tmp_path / "ck.npz"), tmp_path / "s.json"
    save_checkpoint(ck, model)
    outs = []
    for run in ("a", "b"):
        out = tmp_path / run
        rc = cli.main(["-m", ck, "-i", str(png_dir), "-o", str(out), "--arch", "unet_s",
                       "--device", "cpu", "--no-postprocess", "--int8",
                       "--int8-scales", str(scales)])
        assert rc == 0 and scales.exists()
        outs.append({p.name: np.asarray(Image.open(p)) for p in sorted(out.iterdir())})
    assert outs[0].keys() == outs[1].keys() == {"a.png", "b.png", "c.png"}
    for name in outs[0]:
        np.testing.assert_array_equal(outs[0][name], outs[1][name])
    pq = Predictor(model, device="cpu", quantize=True)
    pq.load_calibration(str(scales))
    want = pq.predict_paths(collect_image_files(str(png_dir)), postprocess=False, save=False)
    for path, mask in want.items():
        np.testing.assert_array_equal(outs[1][os.path.basename(path)],
                                      np.asarray(mask_to_image(mask)))


@pytest.mark.parametrize("flags", [["-p"], ["--postprocess"], ["-p", "--no-postprocess"], []])
def test_cli_parses_the_jax_postprocess_flags(flags, monkeypatch):
    """-p / --postprocess (a no-op that keeps the default on) parse in both
    packages' predict CLIs to the same postprocess value."""
    from unet_medical_image_contour_segmentation_tpu.cli import predict as jax_cli

    argv = ["-m", "a.npz", "-i", "x", *flags]
    monkeypatch.setattr("sys.argv", ["predict", *argv])
    want = jax_cli.get_args().postprocess
    assert cli.get_args(argv).postprocess == want == (flags != ["-p", "--no-postprocess"])


@pytest.mark.parametrize("flag", ["-v", "--viz"])
def test_cli_viz_short_form_is_not_ported(flag, monkeypatch):
    """JAX's -v is its --viz, and parses to the same value in both packages'
    predict CLIs."""
    from unet_medical_image_contour_segmentation_tpu.cli import predict as jax_cli

    monkeypatch.setattr("sys.argv", ["predict", "-m", "a.npz", "-i", "x", flag])
    assert cli.get_args(["-m", "a.npz", "-i", "x", flag]).viz is jax_cli.get_args().viz is True
