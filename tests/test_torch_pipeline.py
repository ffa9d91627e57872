"""The port's RAW -> contour-JSON pipeline against the JAX package's, on the CPU.

Each re-homed host stage must write what its JAX twin writes, bit for bit:
PNG pixels, ``original_sizes.json``, ``.npy`` arrays, labelme JSON and the
overlay PNG.  ``run_pipeline`` runs end to end on synthetic RAW scans twice:
with a threshold predictor on both sides (the plumbing, exact), and with
seeded unet_t predictors (the stage-3 masks agree wherever the port's f32
logits have a top-two margin of at least 1e-4; the later stages then see the
same masks).
"""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import build_model, write_raw_scans
from unet_medical_image_contour_segmentation_torch import config as TCFG
from unet_medical_image_contour_segmentation_torch import pipeline as TP
from unet_medical_image_contour_segmentation_torch.cli import seg_main as seg_cli
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import save_checkpoint
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet, unet_t
from unet_medical_image_contour_segmentation_tpu import config as JCFG
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_t as jax_unet_t
from unet_medical_image_contour_segmentation_tpu.pipeline import letterbox as JL
from unet_medical_image_contour_segmentation_tpu.pipeline import mask2polygon as JM
from unet_medical_image_contour_segmentation_tpu.pipeline import raw2png as JR
from unet_medical_image_contour_segmentation_tpu.pipeline import raw_normalize as JN
from unet_medical_image_contour_segmentation_tpu.pipeline import seg_main as JS

MARGIN = 1e-4
WINDOW = dict(window_width=30000, window_length=35000)


def assert_same_files(a: Path, b: Path) -> int:
    """Same file names; PNGs equal in pixels, JSON equal in content, .npy
    equal in values.  Returns the number of files compared."""
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir()) and names, (a, b)
    for name in names:
        pa, pb = a / name, b / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(pa)), np.asarray(Image.open(pb)))
        elif name.endswith(".json"):
            assert json.loads(pa.read_text()) == json.loads(pb.read_text()), name
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(pa), np.load(pb))
        else:
            assert pa.read_bytes() == pb.read_bytes(), name
    return len(names)


def assert_same_stages(a: Path, b: Path) -> None:
    for stage in TP.STAGES.values():
        assert_same_files(a / stage, b / stage)


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("raws")
    write_raw_scans(d, seed=3, n=2, width=160, height=112)
    return d


def test_windowing_and_raw_read_match_jax(raw_dir):
    img = np.random.default_rng(0).integers(0, 65536, (64, 80)).astype(np.uint16)
    for wl, ww in ((30000, 20000), (35000, 30001), (100, 50)):
        np.testing.assert_array_equal(TP.apply_windowing(img, wl, ww),
                                      JR.apply_windowing(img, wl, ww))
    path = str(raw_dir / "scan00.raw")
    np.testing.assert_array_equal(TP.read_16bit_raw(path, 160, 112),
                                  JR.read_16bit_raw(path, 160, 112))


def test_raw2png_matches_jax(raw_dir, tmp_path):
    for mod, out in ((TP, "port"), (JR, "jax")):
        conv = mod.RawToPngConverter(str(raw_dir), str(tmp_path / out), width=160, height=112,
                                     **WINDOW)
        assert conv.convert() == (2, 0)
    assert assert_same_files(tmp_path / "port", tmp_path / "jax") == 2
    assert Image.open(tmp_path / "port" / "scan00.png").mode == "L"


def test_raw2png_main(raw_dir, tmp_path):
    TP.raw2png.main(["--input", str(raw_dir / "scan01.raw"), "--output", str(tmp_path),
                     "-w", "160", "--height", "112", "-ww", "30000", "-wl", "35000"])
    assert (tmp_path / "scan01.png").exists()


@pytest.mark.parametrize("wh", [(160, 112), (112, 160)])
def test_raw_normalize_matches_jax(tmp_path, wh):
    w, h = wh
    src = tmp_path / "in"
    src.mkdir()
    write_raw_scans(src, seed=4, n=2, width=w, height=h)
    for mod, out in ((TP, "port"), (JN, "jax")):
        res = mod.RawNormalizer(str(src), str(tmp_path / out), width=w, height=h,
                                target_size=64).normalize()
        assert res == {"processed": 2, "failed": 0, "total": 2}
    assert assert_same_files(tmp_path / "port", tmp_path / "jax") == 3
    img = np.random.default_rng(1).random((37, 53), dtype=np.float32)
    np.testing.assert_array_equal(TP.nearest_resize_reference(img, 20, 29, 29 / 53),
                                  JN.nearest_resize_reference(img, 20, 29, 29 / 53))


@pytest.mark.parametrize("size", [(100, 60), (60, 100), (512, 512), (777, 333)])
def test_letterbox_matches_jax(tmp_path, size):
    rng = np.random.default_rng(size[0])
    src = tmp_path / "in"
    src.mkdir()
    Image.fromarray(rng.integers(0, 256, size[::-1], dtype=np.uint8)).save(src / "a.png")
    Image.fromarray(rng.integers(0, 256, (*size[::-1], 3), dtype=np.uint8)).save(src / "b.png")
    for mod, out in ((TP, "port"), (JL, "jax")):
        mod.PngNormalizer(str(src), str(tmp_path / out / "norm")).normalize()
        mod.PngDenormalizer(str(tmp_path / out / "norm"), str(tmp_path / out / "back"),
                            str(tmp_path / out / "norm" / "original_sizes.json")).denormalize()
    for stage in ("norm", "back"):
        assert_same_files(tmp_path / "port" / stage, tmp_path / "jax" / stage)
    assert TP.letterbox_geometry(*size) == JL.letterbox_geometry(*size)
    assert np.asarray(Image.open(tmp_path / "port" / "back" / "a.png")).shape == size[::-1]


def test_letterbox_single_file_and_mains(tmp_path):
    img = Image.fromarray(np.random.default_rng(2).integers(0, 256, (90, 70), dtype=np.uint8))
    img.save(tmp_path / "one.png")
    for mod, out in ((TP.letterbox, "port"), (JL, "jax")):
        (tmp_path / out).mkdir()
        mod.PngNormalizer(str(tmp_path / "one.png"), str(tmp_path / out),
                          target_size=64).normalize()
    assert_same_files(tmp_path / "port", tmp_path / "jax")
    assert (tmp_path / "port" / "one_sizes.json").exists()
    TP.letterbox.main_normalize(["--input", str(tmp_path / "one.png"), "-o",
                                 str(tmp_path / "m"), "-s", "64"])
    TP.letterbox.main_denormalize(["-i", str(tmp_path / "m"), "-o", str(tmp_path / "mb"),
                                   "-j", str(tmp_path / "m" / "one_sizes.json"), "-s", "64"])
    assert np.asarray(Image.open(tmp_path / "mb" / "one.png")).shape == (90, 70)


def _masks_and_sizes(root: Path):
    rng = np.random.default_rng(5)
    (root / "masks").mkdir(parents=True)
    (root / "1_raw_png").mkdir()
    sizes = {}
    for k, (w, h) in enumerate(((120, 90), (80, 100))):
        mask = np.zeros((h, w), np.uint8)
        mask[10:50, 20:70] = 255
        mask[60:80, 5 + k:30] = 255
        Image.fromarray(mask).save(root / "masks" / f"m{k}.png")
        Image.fromarray(rng.integers(0, 256, (h, w), dtype=np.uint8)).save(
            root / "1_raw_png" / f"m{k}.png")
        sizes[f"m{k}.png"] = {"width": w, "height": h}
    Image.fromarray(np.zeros((40, 40), np.uint8)).save(root / "masks" / "empty.png")
    sizes["empty.png"] = {"width": 40, "height": 40}
    (root / "sizes.json").write_text(json.dumps(sizes))


def test_mask2polygon_matches_jax(tmp_path):
    _masks_and_sizes(tmp_path)
    for mod, out in ((TP, "port"), (JM, "jax")):
        res = mod.MaskProcessor(str(tmp_path / "masks"), str(tmp_path / out),
                                str(tmp_path / "sizes.json")).process()
        assert res == {"total": 3, "success": 2, "failed": 1}
    # m0.json, m1.json and their overlays drawn on 1_raw_png/m{k}.png
    assert assert_same_files(tmp_path / "port", tmp_path / "jax") == 4
    data = json.loads((tmp_path / "port" / "m0.json").read_text())
    assert data["version"] == "1.0.2.799" and len(data["shapes"]) == 2
    contours = TP.mask_to_polygons(np.asarray(Image.open(tmp_path / "masks" / "m1.png")))
    want = JM.mask_to_polygons(np.asarray(Image.open(tmp_path / "masks" / "m1.png")))
    assert [c.tolist() for c in contours] == [c.tolist() for c in want]
    assert TP.build_labelme_json("x", contours, 3, 4) == JM.build_labelme_json("x", want, 3, 4)
    with pytest.raises(FileNotFoundError):
        TP.MaskProcessor(str(tmp_path / "masks"), None, str(tmp_path / "nope.json"))


def test_pipeline_config_matches_jax():
    import dataclasses

    for name in ("PipelineConfig", "PostProcessConfig"):
        port, jax_cls = getattr(TCFG, name), getattr(JCFG, name)
        assert ([(f.name, f.default) for f in dataclasses.fields(port)]
                == [(f.name, f.default) for f in dataclasses.fields(jax_cls)])


def pipeline_cfg(mod, raw_dir, root, **kw):
    kw.setdefault("model", "unused")
    return mod.PipelineConfig(input_raw=str(raw_dir), output_root=str(root), width=160,
                              height=112, **WINDOW, **kw)


class PortThreshold(Predictor):
    """Class 2 where the image is bright: exact plumbing, no model."""

    def _predict_device(self, images, out_hw=None):
        g = images[..., 0] if images.ndim == 4 else images
        return torch.from_numpy((g > 0.7).astype(np.int32) * 2)


class JaxThreshold(JaxPredictor):
    def _predict_device(self, images):
        g = images[..., 0] if images.ndim == 4 else images
        return (g > 0.7).astype(np.int32) * 2


def test_run_pipeline_plumbing_matches_jax(raw_dir, tmp_path):
    model = build_model(6, unet_t)
    params, state, _ = params_from_state_dict(model.state_dict())
    port_out = TP.run_pipeline(pipeline_cfg(TCFG, raw_dir, tmp_path / "port"),
                               predictor=PortThreshold(model, device="cpu"))
    jax_out = JS.run_pipeline(pipeline_cfg(JCFG, raw_dir, tmp_path / "jax"),
                              predictor=JaxThreshold(jax_unet_t(1, 3), params, state))
    assert Path(port_out) == tmp_path / "port" / "5_json_results"
    assert Path(jax_out) == tmp_path / "jax" / "5_json_results"
    assert_same_stages(tmp_path / "port", tmp_path / "jax")
    data = json.loads((Path(port_out) / "scan00.json").read_text())
    assert (data["imageWidth"], data["imageHeight"]) == (160, 112) and data["shapes"]


def test_run_pipeline_with_models_matches_jax(raw_dir, tmp_path):
    """Seeded unet_t predictors on both sides (class 2 raised so that the
    masks have regions to trace): stage 3 agrees on decided pixels."""
    model = build_model(7, unet_t, class2_share=0.6)
    params, state, _ = params_from_state_dict(model.state_dict())
    jax_params = jax.tree.map(jnp.asarray, (params, state))
    port = Predictor(model, device="cpu")
    TP.run_pipeline(pipeline_cfg(TCFG, raw_dir, tmp_path / "port"), predictor=port)
    JS.run_pipeline(pipeline_cfg(JCFG, raw_dir, tmp_path / "jax"),
                    predictor=JaxPredictor(jax_unet_t(1, 3), *jax_params))
    for stage in ("1_raw_png", "2_normalized_png"):
        assert_same_files(tmp_path / "port" / stage, tmp_path / "jax" / stage)
    norm = tmp_path / "port" / "2_normalized_png"
    names = sorted(p.name for p in norm.glob("*.png"))
    assert names == sorted(p.name for p in (tmp_path / "port" / "3_pred_masks").iterdir())
    for name in names:
        x = np.asarray(Image.open(norm / name), np.float32)[None, ..., None] / 255.0
        with torch.no_grad():
            logits = port.model(torch.from_numpy(x))[0].numpy()
        top2 = np.sort(logits, axis=-1)[..., -2:]
        ok = top2[..., 1] - top2[..., 0] >= MARGIN
        assert ok.mean() > 0.99
        got = np.asarray(Image.open(tmp_path / "port" / "3_pred_masks" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / "3_pred_masks" / name))
        assert (got == 255).mean() > 0.05  # class 2 regions survive the clean-up
        np.testing.assert_array_equal(got[ok], want[ok])
    assert os.listdir(tmp_path / "port" / "5_json_results")


def test_run_pipeline_refuses_int8_and_empty_stages(raw_dir, tmp_path):
    """cfg.int8 with a float predictor is refused; with int8_scales, run A
    calibrates and writes the JSON, run B loads it (JAX
    test_pipeline_int8_scales_roundtrip), and the stage-3 masks are equal.
    An empty RAW directory fails stage 1."""
    model = build_model(7, unet_t, class2_share=0.6)
    with pytest.raises(ValueError, match="quantize=True"):
        TP.run_pipeline(pipeline_cfg(TCFG, raw_dir, tmp_path / "f", int8=True),
                        predictor=Predictor(model, device="cpu"))
    scales = tmp_path / "scales.json"
    for run in ("qa", "qb"):
        pred = Predictor(model, device="cpu", quantize=True)
        TP.run_pipeline(pipeline_cfg(TCFG, raw_dir, tmp_path / run, int8=True,
                                     int8_scales=str(scales)), predictor=pred)
        assert scales.exists() and pred._amax == json.loads(scales.read_text())
    assert_same_files(tmp_path / "qa" / "3_pred_masks", tmp_path / "qb" / "3_pred_masks")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(RuntimeError, match="stage 1"):
        TP.run_pipeline(pipeline_cfg(TCFG, empty, tmp_path / "b"))
    assert sorted(os.listdir(tmp_path / "b")) == sorted(TP.STAGES.values())


@pytest.fixture
def full_unet_npz(tmp_path):
    """The pipeline's default model, the full unet, with class 2 raised."""
    path = tmp_path / "unet.npz"
    save_checkpoint(str(path), build_model(8, unet, class2_share=0.6))
    return path


def test_seg_main_cli_matches_jax(raw_dir, full_unet_npz, tmp_path, monkeypatch):
    """The CLI on the CPU, default model (unet 64..1024, from .npz) at a
    128x128 letterbox; the JAX run_pipeline on the same weights writes the
    same stage-1/2 files and, for the same masks, the same labelme JSON."""
    monkeypatch.chdir(tmp_path)
    rc = seg_cli.main(["--input-raw", str(raw_dir), "-o", str(tmp_path / "port"),
                       "--width", "160", "--height", "112", "-ww", "30000", "-wl", "35000",
                       "-m", str(full_unet_npz), "--target-size", "128", "--device", "cpu"])
    assert rc == 0
    JS.run_pipeline(pipeline_cfg(JCFG, raw_dir, tmp_path / "jax", target_size=128,
                                 model=str(full_unet_npz)))
    for stage in ("1_raw_png", "2_normalized_png"):
        assert_same_files(tmp_path / "port" / stage, tmp_path / "jax" / stage)
    masks = tmp_path / "port" / "3_pred_masks"
    assert len(os.listdir(masks)) == 2
    # stages 4-5 of the JAX package on the port's masks write the port's files
    JL.PngDenormalizer(str(masks), str(tmp_path / "j4"),
                       str(tmp_path / "port" / "2_normalized_png" / "original_sizes.json"),
                       target_size=128).denormalize()
    assert_same_files(tmp_path / "port" / "4_denormalized_masks", tmp_path / "j4")
    (tmp_path / "j5").mkdir()
    JM.MaskProcessor(str(tmp_path / "j4"), str(tmp_path / "j5"),
                     str(tmp_path / "port" / "2_normalized_png" / "original_sizes.json")
                     ).process()
    port5 = tmp_path / "port" / "5_json_results"
    for name in os.listdir(tmp_path / "j5"):
        if name.endswith(".json"):
            assert json.loads((port5 / name).read_text()) == json.loads(
                (tmp_path / "j5" / name).read_text())
    assert any(n.endswith(".json") for n in os.listdir(port5))


def test_seg_main_cli_refuses_int8_and_reports_failure(raw_dir, full_unet_npz, tmp_path,
                                                       monkeypatch):
    """--int8 --int8-scales are accepted and write the calibration JSON (the
    default full unet at a 128x128 letterbox); a missing checkpoint exits 1."""
    monkeypatch.chdir(tmp_path)
    base = ["--input-raw", str(raw_dir), "--width", "160", "--height", "112", "-ww", "30000",
            "-wl", "35000", "--device", "cpu"]
    args = seg_cli.get_args(base + ["-m", "x.npz", "--int8", "--int8-scales", "s.json"])
    assert args.int8 and args.int8_scales == "s.json"
    rc = seg_cli.main(base + ["-m", str(full_unet_npz), "-o", str(tmp_path / "q"),
                              "--target-size", "128", "--int8", "--int8-scales", "s.json"])
    assert rc == 0 and set(json.loads((tmp_path / "s.json").read_text())) >= {"x", "up4.c2"}
    assert os.listdir(tmp_path / "q" / "3_pred_masks")
    assert seg_cli.main(base + ["-m", "missing.npz", "-o", str(tmp_path / "out")]) == 1


def test_seg_main_cli_runs_as_a_module(tmp_path):
    import subprocess

    r = subprocess.run([sys.executable, "-m",
                        "unet_medical_image_contour_segmentation_torch.cli.seg_main", "--help"],
                       capture_output=True, text=True, timeout=120,
                       cwd=Path(__file__).resolve().parent.parent)
    assert r.returncode == 0 and "--device" in r.stdout and "--int8" in r.stdout
