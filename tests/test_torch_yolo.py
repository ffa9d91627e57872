"""YOLOv8-seg in the port against the JAX package's ``models/yolov8_seg.py``,
f32 on the CPU, on seeded numpy weights in the JAX layout (``chip_smoke``'s
``random_params_like``), carried into the port by ``state_dict_from_jax``.

Tolerances: eval logits to 1e-4; train-mode forward to 1e-3 (BN variance
sums in other orders); the binary train step's gradients to 1e-5 of
JAX's f64 gradients.  YOLOv8-seg serves with live BN (nothing folds); its
int8 path is held against JAX's in ``tests/test_torch_yolo_int8.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_params_like, rect_batch, seeded_model, tiled_logits
from unet_medical_image_contour_segmentation_torch.cli import export_model as export_cli
from unet_medical_image_contour_segmentation_torch.cli import predict as predict_cli
from unet_medical_image_contour_segmentation_torch.cli import train as train_cli
from unet_medical_image_contour_segmentation_torch.engine import checkpoint as TC
from unet_medical_image_contour_segmentation_torch.engine import onnx_export as TO
from unet_medical_image_contour_segmentation_torch.engine.export import _dims, export_program
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    ExportedPredictor,
    Predictor,
    collect_image_files,
    mask_to_image,
)
from unet_medical_image_contour_segmentation_torch.engine.train import make_train_step
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models import yolov8_seg as TY
from unet_medical_image_contour_segmentation_torch.models.fold_bn import fold_bn, serving_copy
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    params_tree_from_tensors,
    state_dict_from_jax,
    tensors_from_params_tree,
)
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_tpu.engine import checkpoint as JC
from unet_medical_image_contour_segmentation_tpu.engine import onnx_export as JO
from unet_medical_image_contour_segmentation_tpu.engine import optim as JOPT
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
from unet_medical_image_contour_segmentation_tpu.models import yolov8_seg as JY
from unet_medical_image_contour_segmentation_tpu.models.unet import get_model as jax_get_model

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-4
GRAD_ATOL = 1e-5  # against JAX's gradients computed in f64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(seed=0, centre=False, **kw):
    """(port yolov8_seg_s in eval mode, params, state)."""
    model = seeded_model("yolov8_seg_s", seed, centre, **kw)
    params, state, _ = params_from_state_dict(model.state_dict())
    return model, params, state


def _jax(layout="nhwc", **kw):
    return jax_get_model("yolov8_seg_s", layout=layout, **kw)


@pytest.fixture(scope="module")
def seeded():
    return _seeded()


def logits_of(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def test_preset():
    m = get_model("yolov8_seg_s")
    assert isinstance(m, TY.YOLOv8Seg) and m.widths == (32, 64, 128, 256, 512)
    assert (m.depths, m.n_classes, m.hw_divisor, m.name) == ((1, 2, 2, 1), 1, 32,
                                                             "yolov8_seg_s")
    assert [f"m{k}" for k in range(2)] == [n for n, _ in m.c2f1.named_children()][2:]


def test_weights_have_the_jax_structure(seeded):
    _, params, state = seeded
    want = jax.eval_shape(_jax().init, jax.random.PRNGKey(0))
    assert jax.tree.structure((params, state)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves(want)):
        assert a.shape == b.shape


@pytest.mark.parametrize("hw", [(64, 64), (96, 128)])
def test_eval_logits_match_jax(seeded, hw):
    model, params, state = seeded
    x = np.random.default_rng(1).random((2, *hw, 1), dtype=np.float32)
    want, _ = _jax().apply(params, state, jnp.asarray(x), train=False)
    got = logits_of(model, x)
    assert got.shape == (2, *hw, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_three_class_model_matches_jax():
    model, params, state = _seeded(seed=1, n_classes=3)
    x = np.random.default_rng(2).random((2, 96, 128), dtype=np.float32)
    want, _ = _jax(n_classes=3).apply(params, state, jnp.asarray(x), train=False)
    np.testing.assert_allclose(logits_of(model, x), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_silu_rounds_as_jax(dtype):
    """SiLU in f32, cast back: bit-equal to JAX's in bf16 too."""
    x = np.random.default_rng(3).normal(0, 4, (4096,)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    y = jnp.asarray(x).astype(jdt)
    want = (y.astype(jnp.float32) * jax.nn.sigmoid(y.astype(jnp.float32))).astype(jdt)
    got = TY.silu_f32(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=1e-6 if dtype == torch.float32 else 0, atol=0)


def test_nearest_upsample_and_sppf_pool_match_jax():
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 7, 3)).astype(np.float32)
    want_up = jnp.repeat(jnp.repeat(jnp.asarray(x), 2, axis=1), 2, axis=2)
    np.testing.assert_array_equal(TY.upsample_nearest2(torch.from_numpy(x)).numpy(), want_up)
    np.testing.assert_array_equal(TY.maxpool5_same(torch.from_numpy(x)).numpy(),
                                  JY._maxpool5_same(jnp.asarray(x)))


def test_train_forward_and_running_stats_match_jax(seeded):
    _, params, state = seeded
    model = get_model("yolov8_seg_s")
    model.load_state_dict(state_dict_from_jax(params, state))
    x = np.random.default_rng(5).random((2, 64, 64, 1), dtype=np.float32)
    want, new_state = _jax().apply(params, state, jnp.asarray(x), train=True)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    _, got_state, _ = params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_binary_train_step_matches_jax():
    """One step of the binary criterion (BCE + Dice + boundary), as JAX's
    YOLO test trains it, at (2, 64, 64) against JAX's same forward and loss
    in f64: the loss terms to 1e-5, the clipped gradients to GRAD_ATOL and
    the grad norm to 1e-5, the new BN running statistics to 1e-5."""
    model, params, state = _seeded(seed=2)
    model.train()
    batch = rect_batch(172, 2, 64, 64)
    jm, cfg = _jax(), JL.LossConfig(n_classes=1)
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def loss_fn(p):
            logits, new_state = jm.apply(p, f64(state), jnp.asarray(batch["image"], jnp.float64),
                                         train=True)
            loss, metrics = JL.compute_loss(logits, jnp.asarray(batch["mask"]), cfg)
            return loss, (metrics, new_state)

        (_, (want, want_bn)), want_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(f64(params))
        want_grads, want_norm = JOPT.clip_by_global_norm(want_grads, 1.0)
        want_grads, want_norm, want_bn = _leaves(want_grads), float(want_norm), _leaves(want_bn)
        want = {k: float(v) for k, v in want.items()}
    step = make_train_step(model, LossConfig(n_classes=1), RMSpropConfig(learning_rate=LR))
    got = step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    assert set(want) <= set(got)
    for k in set(want) - {"grad_norm", "lr"}:
        assert got[k].item() == pytest.approx(want[k], rel=1e-5), k
    assert got["grad_norm"].item() == pytest.approx(want_norm, rel=1e-5)
    got_grads = params_tree_from_tensors(model, {n: p.grad for n, p in model.named_parameters()})
    assert max(np.abs(a - b).max() for a, b in zip(_leaves(got_grads), want_grads)) <= GRAD_ATOL
    _, got_bn, _ = params_from_state_dict(model.state_dict())
    assert max(np.abs(a - b).max() for a, b in zip(_leaves(got_bn), want_bn)) <= 1e-5


def test_carrier_round_trips(seeded):
    model, params, state = seeded
    again = get_model("yolov8_seg_s")
    again.load_state_dict(state_dict_from_jax(params, state))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0, msg=k)
    tensors = {n: torch.randn_like(p) for n, p in model.named_parameters()}
    tree = params_tree_from_tensors(model, tensors)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    back = tensors_from_params_tree(model, tree)
    for n in tensors:
        torch.testing.assert_close(back[n], tensors[n], rtol=0, atol=0, msg=n)


def test_npz_checkpoints_cross_packages(seeded, tmp_path):
    """An .npz of either package loads in the other; .pth is refused both
    ways, as the JAX package has none for YOLO."""
    model, params, state = seeded
    JC.save_checkpoint(str(tmp_path / "j.npz"), params, state)
    sd, _ = TC.load_weights(str(tmp_path / "j.npz"))
    port = get_model("yolov8_seg_s")
    port.load_state_dict(sd)
    x = np.random.default_rng(6).random((1, 64, 64, 1), dtype=np.float32)
    np.testing.assert_array_equal(logits_of(port.eval(), x), logits_of(model, x))
    TC.save_checkpoint(str(tmp_path / "t.npz"), port)
    ck = JC.load_checkpoint(str(tmp_path / "t.npz"))
    for a, b in zip(_leaves((ck["params"], ck["bn_state"])), _leaves((params, state))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="npz"):
        TC.save_checkpoint(str(tmp_path / "t.pth"), port)
    torch.save(port.state_dict(), tmp_path / "y.pth")
    with pytest.raises(ValueError, match="npz"):
        TC.load_weights(str(tmp_path / "y.pth"))


def test_predictor_serves_with_live_bn_as_jax():
    """Nothing folds (fold_bn raises KeyError), so the Predictor serves an
    eval copy with live BN; binary masks (sigmoid > 0.5) equal JAX's
    dense Predictor's where the logit is not within 1e-4 of 0."""
    model, params, state = _seeded(seed=3, centre=True)
    with pytest.raises(KeyError):
        fold_bn(model)
    pred = Predictor(model, device="cpu")
    assert not pred.model.training and pred.hw_divisor == 32
    x = np.random.default_rng(7).random((2, 64, 96, 1), dtype=np.float32)
    got = pred.predict_array(x)
    want = np.asarray(JaxPredictor(_jax(layout="auto"),
                                   jax.tree.map(jnp.asarray, params),
                                   jax.tree.map(jnp.asarray, state)).predict_array(x))
    ok = np.abs(logits_of(model, x)[..., 0]) >= 1e-4
    assert ok.mean() > 0.99 and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got[ok], want[ok])


def test_tiled_matches_jax():
    """Above tile_threshold, tiles of 64 with a 48 halo (windows of 160, a
    multiple of 32), against JAX's tiled serving of the same weights."""
    model, params, state = _seeded(seed=4, centre=True)
    x = np.random.default_rng(8).random((1, 96, 160, 1), dtype=np.float32)
    got = Predictor(model, device="cpu", tile=64, tile_halo=48,
                    tile_threshold=64 * 64).predict_array(x)
    jp = JaxPredictor(_jax(layout="auto"), jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, state), tile=64, tile_halo=48,
                      tile_threshold=64 * 64)
    want = np.asarray(jp.predict_array(x))
    logits = tiled_logits(serving_copy(model), torch.from_numpy(x), 64, 48)[..., 0]
    ok = logits.abs().numpy() >= 1e-4
    assert ok.mean() > 0.99 and 0.05 < want.mean() < 0.95
    np.testing.assert_array_equal(got[ok], want[ok])


def test_onnx_bytes_equal_jax(seeded, tmp_path):
    """The port's writer emits JAX build_yolov8_onnx's bytes (SiLU as
    Sigmoid + Mul), and the graph run by run_with_torch gives the eval
    forward's logits."""
    model, params, state = seeded
    got = TO.export_onnx(model, str(tmp_path / "p.onnx"))
    want = JO.export_onnx(_jax(), params, state, str(tmp_path / "j.onnx"))
    assert got == want
    x = np.random.default_rng(9).random((1, 1, 64, 96), np.float32)
    np.testing.assert_allclose(TO.run_with_torch(got, x),
                               logits_of(model, x.transpose(0, 2, 3, 1)).transpose(0, 3, 1, 2),
                               **TOL)


def test_program_serves_on_the_cpu():
    """A static .pt2 program of yolov8_seg_s (live BN) served by
    ExportedPredictor: the live Predictor's masks; the symbolic H and W of a
    dynamic program are multiples of 32.  (A dynamic program takes ~20 s to
    trace here; chip_smoke's C4 serves one at 512² and 1024x768.)"""
    model, _, _ = _seeded(seed=5, centre=True)
    data = export_program(model, device="cpu", example_hw=(64, 96), dynamic_batch=False,
                          dynamic_hw=False)
    program = ExportedPredictor(data, device="cpu", tile_threshold=0, batch_size=2)
    x = np.random.default_rng(10).random((2, 64, 96, 1), dtype=np.float32)
    np.testing.assert_array_equal(program.predict_array(x),
                                  Predictor(model, device="cpu").predict_array(x))
    dims = _dims(True, True, model.hw_divisor)
    assert "32*" in str(dims[1]) and "32*" in str(dims[2])


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A yolov8_seg_s .npz (binary) and a directory of two 64x64 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("yolo")
    model, _, _ = _seeded(seed=6, centre=True)
    TC.save_checkpoint(str(root / "y.npz"), model)
    (root / "pngs").mkdir()
    rng = np.random.default_rng(11)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
            root / "pngs" / f"{name}.png")
    return model, root


def test_predict_cli_serves_yolo(checkpoint):
    from PIL import Image

    model, root = checkpoint
    out = root / "out"
    assert predict_cli.main(["-m", str(root / "y.npz"), "-i", str(root / "pngs"), "-o",
                             str(out), "--arch", "yolov8_seg_s", "--classes", "1", "--device",
                             "cpu", "--no-postprocess"]) == 0
    want = Predictor(model, device="cpu").predict_paths(collect_image_files(str(root / "pngs")),
                                                        postprocess=False, save=False)
    for path, mask in want.items():
        saved = np.asarray(Image.open(out / os.path.basename(path)))
        np.testing.assert_array_equal(saved, np.asarray(mask_to_image(mask)))


def test_export_cli_writes_yolo_onnx(checkpoint, tmp_path):
    _, root = checkpoint
    assert export_cli.main(["-m", str(root / "y.npz"), "--arch", "yolov8_seg_s", "--classes",
                            "1", "--device", "cpu", "-o", str(tmp_path / "y.onnx")]) == 0
    assert TO.parse_model((tmp_path / "y.onnx").read_bytes())["opset"] == 11


def test_train_cli_trains_yolo_binary(tmp_path, monkeypatch):
    """One epoch of yolov8_seg_s with the binary criterion through the train
    CLI on synthetic 64x64 PNGs (scale 1: multiples of 32)."""
    from PIL import Image

    rng = np.random.default_rng(12)
    for split in ("train", "val"):
        (tmp_path / "imgs" / split).mkdir(parents=True)
        (tmp_path / "masks" / split).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
                tmp_path / "imgs" / split / f"c{i}.png")
            Image.fromarray(rng.choice([0, 128, 255], (64, 64)).astype(np.uint8)).save(
                tmp_path / "masks" / split / f"c{i}_mask.png")
    monkeypatch.chdir(tmp_path)
    assert train_cli.main(["--data-root", str(tmp_path), "--epochs", "1", "-b", "2",
                           "--model", "yolov8_seg_s", "--classes", "1", "--scale", "1",
                           "--no-amp", "--no-save-val-predictions", "--no-val-postprocess",
                           "--device", "cpu"]) == 0
    ck = TC.load_checkpoint(str(tmp_path / "model_epoch1.npz"))
    # 2 slices, each in its 4 rotations, in batches of 2
    assert ck["step"] == 4 and "sppf" in ck["params"] and ck["opt_state"] is not None
    assert ck["params"]["head"]["w"].shape == (1, 1, 32, 1)
