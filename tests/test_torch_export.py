"""The port's export against the JAX package's, on the CPU in f32: the ONNX
writer (the same bytes on the same weights), the ``torch.export`` program
against JAX's deserialised StableHLO (float, at two H and W from one
program, and int8 on the same qparams), ``ExportedPredictor`` against
``StableHLOPredictor``, and the export CLI's round trips.

Tolerances: the float programs' logits within 1e-4 (f32 arithmetic in
another order; the port's program runs BN folded into the convs, as it
serves).  The int8 programs: see :func:`test_int8_program_matches_jax`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.cli import export_model as export_cli
from unet_medical_image_contour_segmentation_torch.cli import predict as predict_cli
from unet_medical_image_contour_segmentation_torch.engine import export as TE
from unet_medical_image_contour_segmentation_torch.engine import onnx_export as TO
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import save_checkpoint
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    ExportedPredictor,
    Predictor,
    collect_image_files,
    mask_to_image,
)
from unet_medical_image_contour_segmentation_torch.models.quantize import apply_int8
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    qparams_from_jax,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import UNet
from unet_medical_image_contour_segmentation_tpu.engine import export as JE
from unet_medical_image_contour_segmentation_tpu.engine import onnx_export as JO
from unet_medical_image_contour_segmentation_tpu.engine.predict import StableHLOPredictor
from unet_medical_image_contour_segmentation_tpu.models import quantize as JQ
from unet_medical_image_contour_segmentation_tpu.models.unet import UNet as JaxUNet

WIDTHS_S, WIDTHS_T = (16, 32, 64, 128, 256), (8, 16, 32, 64, 128)
VARIANTS = {  # name: (model kwargs, seeded-weight kwargs)
    "unet_s": ({}, {}),
    "unet_sa": (dict(use_attention=True), dict(attention=True)),
    "bilinear": (dict(bilinear=True), dict(bilinear=True)),
}
TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(name, widths, seed=0):
    kw, wkw = VARIANTS[name]
    params, state = random_unet_params(seed, widths, **wkw)
    model = UNet(widths=widths, name=name, **kw)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model.eval(), JaxUNet(widths=widths, layout="nhwc", **kw), params, state


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_onnx_bytes_equal_jax(name, tmp_path):
    """The same ModelProto bytes as the JAX writer on the same weights, and
    the graph (the torch-backed interpreter) gives the port's eval logits."""
    model, jax_model, params, state = _models(name, WIDTHS_S)
    got = TO.export_onnx(model, str(tmp_path / "port.onnx"))
    want = JO.export_onnx(jax_model, _jnp(params), _jnp(state), str(tmp_path / "jax.onnx"))
    assert got == want == (tmp_path / "port.onnx").read_bytes()
    x = np.random.default_rng(1).random((2, 1, 32, 48), np.float32)
    with torch.no_grad():
        live = model(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy().transpose(0, 3, 1, 2)
    np.testing.assert_allclose(TO.run_with_torch(got, x), live, **TOL)


@pytest.fixture(scope="module", params=["unet_s", "bilinear"])
def programs(request):
    """One port program and one JAX StableHLO program of a unet_t-width
    model (ConvTranspose or bilinear ups), both dynamic in B, H and W."""
    model, jax_model, params, state = _models(request.param, WIDTHS_T)
    data = TE.export_program(model, example_hw=(64, 64), device="cpu")
    jax_data = JE.export_stablehlo(jax_model, _jnp(params), _jnp(state), platforms=("cpu",))
    return model, data, jax_data


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 48, 80)])
def test_program_matches_jax_stablehlo(programs, shape):
    """One program of each package, two sizes: the logits within 1e-4."""
    _, data, jax_data = programs
    x = np.random.default_rng(2).random((*shape, 1), np.float32)
    with torch.no_grad():
        got = TE.load_exported(data).module()(torch.from_numpy(x)).numpy()
    want = np.asarray(JE.load_exported(jax_data).call(jnp.asarray(x)))
    assert got.shape == want.shape == (*shape, 3)
    np.testing.assert_allclose(got, want, **TOL)


def test_program_sanity_check_and_bad_device(programs):
    model, data, _ = programs
    assert TE.sanity_check(data, model, hw=(32, 32), device="cpu")
    assert not TE.logits_close(np.ones((1, 4, 4, 3)), np.zeros((1, 4, 4, 3)), "zeros")


def _agreement(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


@pytest.mark.parametrize("uint8", [False, True])
def test_exported_predictor_matches_stablehlo_predictor(programs, uint8):
    """Masks of a dense batch, a back-resized batch and a tiled image
    (tile 32, halo 8, threshold 0) against JAX's StableHLOPredictor on its
    program of the same weights: f32 logits agree within 1e-4, so only a
    pixel that near a class tie may flip (at most 0.1%)."""
    _, data, jax_data = programs
    ours = ExportedPredictor(data, device="cpu")
    theirs = StableHLOPredictor(jax_data)
    rng = np.random.default_rng(3)
    images = rng.random((3, 64, 64, 1), np.float32)  # JAX's program takes (B, H, W, C)
    if uint8:
        images = np.round(images * 255).astype(np.uint8)
    for out_hw in (None, (50, 70)):
        assert _agreement(ours.predict_array(images, out_hw),
                          theirs.predict_array(images, out_hw)) >= 0.999
    tiled = [p(tile=32, tile_halo=8, tile_threshold=0) for p in (
        lambda **kw: ExportedPredictor(data, device="cpu", **kw),
        lambda **kw: StableHLOPredictor(jax_data, **kw))]
    big = images[:1]
    assert _agreement(tiled[0].predict_array(big), tiled[1].predict_array(big)) >= 0.999


def test_int8_program_matches_jax(tmp_path):
    """The int8 programs of both packages from JAX's qparams (calibrated on
    the same images), at their static 64x64: the port's program equals the
    port's eager int8 forward exactly; against JAX's program, which XLA
    compiles under jit (it contracts the requant's multiply and add into one
    FMA where the port rounds twice, so an activation may land one LSB off
    and carry on), the logits within 2% of their range and the argmax on
    >= 99%."""
    model, jax_model, params, state = _models("unet_s", WIDTHS_T)
    x = np.random.default_rng(4).random((2, 64, 64, 1), np.float32)
    fp = JQ.fold_for_quantize(jax_model, _jnp(params), _jnp(state))
    qp = JQ.build_qparams(jax_model, fp, JQ.calibrate_amax(jax_model, fp, jnp.asarray(x)))
    ours = qparams_from_jax(qp)
    data = TE.export_program_int8(model, ours, example_hw=(64, 64))
    jax_data = JE.export_stablehlo_int8(jax_model, qp, example_hw=(64, 64), platforms=("cpu",))
    with torch.no_grad():
        got = TE.load_exported(data).module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, apply_int8(ours, torch.from_numpy(x)).numpy())
    want = np.asarray(JE.load_exported(jax_data).call(jnp.asarray(x)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * scale)
    assert _agreement(got.argmax(-1), want.argmax(-1)) >= 0.99


# -- the export CLI ------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    model, _, params, state = _models("unet_s", WIDTHS_S, seed=5)
    path = tmp_path_factory.mktemp("ck") / "model.pth"
    save_checkpoint(str(path), model, mask_values=[0, 128, 255])
    return model, path


def _png_dir(tmp_path):
    from PIL import Image

    d = tmp_path / "pngs"
    d.mkdir()
    rng = np.random.default_rng(6)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(d / f"{name}.png")
    return d


@pytest.mark.parametrize("flags,made", [
    (["-o", "x.pt2"], ["x.pt2"]),
    (["-o", "x.onnx"], ["x.onnx"]),
    (["--format", "both", "-o", "x.pt2"], ["x.pt2", "x.onnx"]),
])
def test_export_cli_round_trip(checkpoint, tmp_path, monkeypatch, flags, made):
    """Each artifact is written and passes its sanity forward; a .pt2 serves
    through the predict CLI with the masks of the live Predictor."""
    from PIL import Image

    model, path = checkpoint
    monkeypatch.chdir(tmp_path)
    assert export_cli.main(["-m", str(path), "--arch", "unet_s", "--device", "cpu",
                            *flags]) == 0
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix in (".pt2", ".onnx")) == \
        sorted(made)
    if "x.pt2" not in made:
        return
    pngs = _png_dir(tmp_path)
    assert predict_cli.main(["-m", "x.pt2", "-i", str(pngs), "-o", "out", "--device", "cpu",
                             "--no-postprocess", "--int8"]) == 0
    want = Predictor(model, device="cpu").predict_paths(collect_image_files(str(pngs)),
                                                        postprocess=False, save=False)
    for p, mask in want.items():
        got = Image.open(tmp_path / "out" / os.path.basename(p))
        assert _agreement(got, mask_to_image(mask)) >= 0.999


def test_export_cli_int8_round_trip(checkpoint, tmp_path, monkeypatch):
    """--int8 --calib writes the scales JSON and an int8 program equal to
    the live int8 forward; a second export loads that JSON, the same bytes
    of weights come out, and the program serves."""
    model, path = checkpoint
    monkeypatch.chdir(tmp_path)
    pngs = _png_dir(tmp_path)
    args = ["-m", str(path), "--arch", "unet_s", "--device", "cpu", "--int8",
            "--int8-hw", "64", "64", "--int8-scales", "s.json"]
    assert export_cli.main([*args, "--calib", str(pngs), "-o", "a.pt2"]) == 0
    assert export_cli.main([*args, "-o", "b.pt2"]) == 0
    a, b = (TE.load_exported(str(tmp_path / n)).module() for n in ("a.pt2", "b.pt2"))
    x = torch.from_numpy(np.random.default_rng(7).random((3, 64, 64, 1), np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(a(x).numpy(), b(x).numpy())
    masks = ExportedPredictor.from_file(str(tmp_path / "a.pt2"), device="cpu",
                                        tile_threshold=0).predict_array(x.numpy())
    assert masks.shape == (3, 64, 64)


@pytest.mark.parametrize("flags", [["--format", "stablehlo"],
                                   ["--format", "stablehlo", "--arch", "yolov8_seg_s"],
                                   ["--format", "stablehlo", "--int8", "--arch", "yolov8_seg_s"]])
def test_export_cli_refuses_what_is_not_the_port(flags, capsys):
    """StableHLO, whatever the architecture and precision: it is the JAX
    package's artifact."""
    with pytest.raises(SystemExit) as exc:
        export_cli.get_args(["-m", "w.npz", *flags])
    assert exc.value.code == 2
    assert "JAX package" in capsys.readouterr().err


def test_export_cli_int8_needs_scales(checkpoint, tmp_path):
    _, path = checkpoint
    assert export_cli.main(["-m", str(path), "--device", "cpu", "--int8",
                            "-o", str(tmp_path / "x.pt2")]) == 1


def test_exported_predictor_refuses_another_device(programs):
    _, data, _ = programs
    with pytest.raises(ValueError, match="serves there"):
        ExportedPredictor(data, device=torch.device("meta"))
