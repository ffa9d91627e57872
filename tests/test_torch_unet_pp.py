"""UNet++ in the port against the JAX package's ``models/unet_nested.py``, f32
on the CPU, on seeded numpy weights in the JAX layout (``chip_smoke``'s
``random_params_like``: He-normal convs, BN affines and running stats off
identity), carried into the port by ``state_dict_from_jax``.

Tolerances: eval logits to 1e-4 (as the UNet's); train-mode forward to
1e-3 (the BN variance's f32 sums in other orders); the train
step's gradients to 1e-5 of JAX's f64 gradients (as the UNet variants');
the int8 forward against JAX's eager ``_forward_pp`` on the same qparams to
the bounds of ``tests/test_torch_quantize.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_params_like, rect_batch, seeded_model, tiled_logits, top2_margin
from unet_medical_image_contour_segmentation_torch.cli import export_model as export_cli
from unet_medical_image_contour_segmentation_torch.cli import predict as predict_cli
from unet_medical_image_contour_segmentation_torch.cli import train as train_cli
from unet_medical_image_contour_segmentation_torch.engine import checkpoint as TC
from unet_medical_image_contour_segmentation_torch.engine import onnx_export as TO
from unet_medical_image_contour_segmentation_torch.engine.export import export_program
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    ExportedPredictor,
    Predictor,
)
from unet_medical_image_contour_segmentation_torch.engine.train import make_train_step
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models import quantize as TQ
from unet_medical_image_contour_segmentation_torch.models.blocks import DoubleConv
from unet_medical_image_contour_segmentation_torch.models.fold_bn import (
    FoldedDoubleConv,
    fold_bn,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    params_tree_from_tensors,
    qparams_from_jax,
    state_dict_from_jax,
    tensors_from_params_tree,
)
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_torch.models.unet_nested import UNetPlusPlus
from unet_medical_image_contour_segmentation_tpu.engine import checkpoint as JC
from unet_medical_image_contour_segmentation_tpu.engine import onnx_export as JO
from unet_medical_image_contour_segmentation_tpu.engine import optim as JOPT
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
from unet_medical_image_contour_segmentation_tpu.models import quantize as JQ
from unet_medical_image_contour_segmentation_tpu.models.fold_bn import fold_params
from unet_medical_image_contour_segmentation_tpu.models.unet import get_model as jax_get_model
from unet_medical_image_contour_segmentation_tpu.models.unet_nested import (
    UNetPlusPlus as JaxUNetPlusPlus,
)

TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-4
GRAD_ATOL = 1e-5  # against JAX's gradients computed in f64
VARIANTS = {"convt": {}, "bilinear": {"bilinear": True},
            "deep_supervision": {"deep_supervision": True}}
NARROW = (8, 16, 32, 64)  # a narrow 4-depth UNet++ (hw_divisor 8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(seed=0, centre=False, **kw):
    """(port model in eval mode, params, state) of unet_pp_s, 3 classes."""
    model = seeded_model("unet_pp_s", seed, centre, n_classes=3, **kw)
    params, state, _ = params_from_state_dict(model.state_dict())
    return model, params, state


def _jax(**kw):
    return jax_get_model("unet_pp_s", n_classes=3, layout="nhwc", **kw)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    kw = VARIANTS[request.param]
    return (*_seeded(**kw), _jax(**kw))


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).random((2, 64, 64, 1), dtype=np.float32)


def logits_of(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def _leaves(tree):
    return [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]


def test_registry_builds_the_presets():
    s, full = get_model("unet_pp_s"), get_model("unet_pp", bilinear=True)
    assert isinstance(s, UNetPlusPlus) and s.widths == (16, 32, 64, 128, 256)
    assert full.widths == (64, 128, 256, 512, 1024) and full.bilinear
    assert (s.name, full.name, s.hw_divisor, s.n_classes) == ("unet_pp_s", "unet_pp", 16, 1)
    assert "up0_1.weight" in s.state_dict() and "up0_1.weight" not in full.state_dict()


def test_weights_have_the_jax_structure(variant):
    """The port's state_dict carries over to exactly the pytree (keys,
    shapes) of the JAX model's own init."""
    _, params, state, jm = variant
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree.structure((params, state)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves(want)):
        assert a.shape == b.shape


def test_eval_logits_match_jax(variant, images):
    """The eval forward and the BN-folded forward against JAX's apply."""
    model, params, state, jm = variant
    want, _ = jm.apply(params, state, jnp.asarray(images), train=False)
    got = logits_of(model, images)
    assert got.shape == (2, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    np.testing.assert_allclose(logits_of(fold_bn(model), images), np.asarray(want), **TOL)


def test_narrow_unet_pp_matches_jax():
    """A 4-depth unet_pp of widths 8..64, 2 classes, at 44x76, where the
    pools floor and the ups are zero-padded to the skips."""
    model = UNetPlusPlus(n_classes=2, widths=NARROW, name="unet_pp")
    params, state = random_params_like(model, 3)
    model.load_state_dict(state_dict_from_jax(params, state))
    jm = JaxUNetPlusPlus(n_classes=2, widths=NARROW, layout="nhwc", name="unet_pp")
    x = np.random.default_rng(2).random((2, 44, 76), dtype=np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), train=False)
    np.testing.assert_allclose(logits_of(model.eval(), x), np.asarray(want), **TOL)


def test_train_forward_and_running_stats_match_jax(images):
    model, params, state = _seeded()
    want, new_state = _jax().apply(params, state, jnp.asarray(images), train=True)
    with torch.no_grad():
        got = model.train()(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    _, got_state, _ = params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_train_step_matches_jax():
    """One multiclass step (CE + Dice) at (2, 32, 32) against JAX's same
    forward and loss in f64 (``jax.enable_x64``): the loss terms to 1e-5,
    the clipped gradients to GRAD_ATOL and the grad norm to 1e-5, the new
    BN running statistics to 1e-5.  (RMSprop's update from the gradients is
    the UNet's, held against JAX's in tests/test_torch_train.py.)"""
    model, params, state = _seeded(seed=5)
    model.train()
    batch = rect_batch(171, 2, 32, 32)
    jm = _jax()
    with jax.enable_x64():
        f64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731

        def loss_fn(p):
            logits, new_state = jm.apply(p, f64(state), jnp.asarray(batch["image"], jnp.float64),
                                         train=True)
            loss, metrics = JL.compute_loss(logits, jnp.asarray(batch["mask"]), JL.LossConfig())
            return loss, (metrics, new_state)

        (_, (want, want_bn)), want_grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(f64(params))
        want_grads, want_norm = JOPT.clip_by_global_norm(want_grads, 1.0)
        want_grads, want_norm, want_bn = _leaves(want_grads), float(want_norm), _leaves(want_bn)
        want = {k: float(v) for k, v in want.items()}
    step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=LR))
    got = step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    for k in ("ce", "dice", "loss"):
        assert got[k].item() == pytest.approx(want[k], rel=1e-5), k
    assert got["grad_norm"].item() == pytest.approx(want_norm, rel=1e-5)
    got_grads = params_tree_from_tensors(model, {n: p.grad for n, p in model.named_parameters()})
    assert max(np.abs(a - b).max() for a, b in zip(_leaves(got_grads), want_grads)) <= GRAD_ATOL
    _, got_bn, _ = params_from_state_dict(model.state_dict())
    assert max(np.abs(a - b).max() for a, b in zip(_leaves(got_bn), want_bn)) <= 1e-5


def test_remat_step_equals_the_plain_step():
    """remat recomputes each node's DoubleConv in the backward; the whole
    state after two steps (BN statistics and num_batches_tracked included)
    is bit-equal to the plain step's."""
    _, params, state = _seeded(seed=6)
    states = {}
    for remat in (False, True):
        model = get_model("unet_pp_s", n_classes=3, remat=remat)
        model.load_state_dict(state_dict_from_jax(params, state))
        step = make_train_step(model, LossConfig(), RMSpropConfig(learning_rate=LR))
        losses = [step({k: torch.from_numpy(v) for k, v in rect_batch(190 + i, 2, 32, 32).items()},
                       LR)["loss"].item() for i in range(2)]
        states[remat] = losses, model.state_dict()
    (plain_losses, plain), (remat_losses, remat) = states[False], states[True]
    assert remat_losses == plain_losses and plain.keys() == remat.keys()
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0, msg=k)
    assert int(remat["x0_4.double_conv.4.num_batches_tracked"]) == 2


def test_carrier_round_trips(variant):
    """params / state / per-parameter tensors (gradients, optimizer state)
    cross both ways bit for bit."""
    model, params, state, _ = variant
    again = get_model("unet_pp_s", n_classes=3, bilinear=model.bilinear,
                      deep_supervision=model.deep_supervision)
    again.load_state_dict(state_dict_from_jax(params, state))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[k], v, rtol=0, atol=0, msg=k)
    tensors = {n: torch.randn_like(p) for n, p in model.named_parameters()}
    tree = params_tree_from_tensors(model, tensors)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    back = tensors_from_params_tree(model, tree)
    assert back.keys() == tensors.keys()
    for n in tensors:
        torch.testing.assert_close(back[n], tensors[n], rtol=0, atol=0, msg=n)


def test_npz_checkpoints_cross_packages(images, tmp_path):
    """An .npz written by JAX loads into the port and one written by the
    port (with its optimizer state) loads into JAX; a .pth is refused, as
    the JAX package has none for UNet++."""
    model, params, state = _seeded(seed=7, deep_supervision=True)
    JC.save_checkpoint(str(tmp_path / "j.npz"), params, state, mask_values=[0, 1, 2])
    sd, mask_values = TC.load_weights(str(tmp_path / "j.npz"))
    port = get_model("unet_pp_s", n_classes=3, deep_supervision=True)
    port.load_state_dict(sd)
    assert mask_values == [0, 1, 2]
    np.testing.assert_array_equal(logits_of(port.eval(), images), logits_of(model, images))

    step = make_train_step(port.train(), LossConfig(), RMSpropConfig(learning_rate=LR))
    step({k: torch.from_numpy(v) for k, v in rect_batch(3, 2, 32, 32).items()}, LR)
    TC.save_checkpoint(str(tmp_path / "t.npz"), port, step=1, optimizer=step.optimizer)
    ck = JC.load_checkpoint(str(tmp_path / "t.npz"))
    got_p, got_s, _ = params_from_state_dict(port.state_dict())
    assert jax.tree.structure(ck["params"]) == jax.tree.structure(got_p)
    for a, b in zip(_leaves((ck["params"], ck["bn_state"])), _leaves((got_p, got_s))):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(ck["opt_state"]["square_avg"]) == jax.tree.structure(got_p)
    with pytest.raises(ValueError, match="npz"):
        TC.save_checkpoint(str(tmp_path / "t.pth"), port)


@pytest.mark.parametrize("deep_supervision", [False, True])
def test_fold_bn_is_exact(images, deep_supervision):
    """fold_bn replaces every node's DoubleConv, and the folded forward
    equals the unfolded one."""
    model, _, _ = _seeded(seed=8, deep_supervision=deep_supervision)
    folded = fold_bn(model)
    assert not any(isinstance(m, DoubleConv) for m in folded.modules())
    assert sum(isinstance(m, FoldedDoubleConv) for m in folded.modules()) == 15
    np.testing.assert_allclose(logits_of(folded, images), logits_of(model, images),
                               rtol=1e-5, atol=1e-5)


# -- int8 (JAX build_qparams_pp / _forward_pp) ---------------------------------


@pytest.fixture(scope="module")
def int8_variant():
    """JAX's side on seeded unet_pp_s weights: the f32 fold, amaxes, qparams
    and the int8 logits at (2, 64, 64), eagerly (as tests/test_torch_quantize.py
    explains: under jax.jit XLA contracts _qconv's multiply-add).  The
    bilinear and deep-supervision walker is held against the float
    Predictor below (JAX's eager int8 forward takes ~10 s a variant)."""
    model, params, state = _seeded(seed=9)
    jm = _jax()
    x = np.random.default_rng(3).random((2, 64, 64), dtype=np.float32)
    fp = fold_params(params, state)
    amax = JQ.calibrate_amax(jm, fp, x)
    qp = JQ.build_qparams_pp(jm, fp, amax)
    return dict(model=model, x=x, amax=amax, qp=qp,
                logits=np.asarray(JQ.apply_wide_int8(jm, qp, x)[0]))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_int8_calibration_and_qparams_match_jax(int8_variant):
    """calibrate_amax to 1e-5 relative; build_qparams_pp from JAX's amaxes:
    mul / badd to 1e-6, int8 weights equal but for round-half ties."""
    v = int8_variant
    tree = TQ.folded_tree(fold_bn(v["model"]))
    got_amax = TQ.calibrate_amax(tree, torch.from_numpy(v["x"]))
    assert set(got_amax) == set(v["amax"])
    for k, want in v["amax"].items():
        assert got_amax[k] == pytest.approx(want, rel=1e-5), k
    got, want = _flat(TQ.build_qparams_pp(tree, v["amax"])), _flat(qparams_from_jax(v["qp"]))
    assert got.keys() == want.keys()
    flips = 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            assert d.max() <= 1, k
            flips += int(d.sum())
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max().item(), msg=k)
    assert flips <= 2


def test_apply_int8_matches_jax_eager(int8_variant):
    """JAX's qparams carried in: the logits agree to 1e-4 of their largest
    magnitude on >= 99.9% of entries, the classes wherever the top-two
    margin exceeds 1e-3."""
    v = int8_variant
    got = TQ.apply_int8(qparams_from_jax(v["qp"]), torch.from_numpy(v["x"]))
    want = v["logits"]
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert (np.abs(got - want) <= 1e-4 * np.abs(want).max()).mean() >= 0.999
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-3
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


@pytest.mark.parametrize("kw", [{}, dict(bilinear=True, deep_supervision=True)],
                         ids=["convt", "bilinear_deep_supervision"])
def test_int8_predictor_serves_unet_pp(kw):
    """Predictor(quantize=True) calibrates on the first batch and serves
    through the UNet++ walker (split conv1s, dequantised nodes for the up
    path and the heads): masks equal to the float Predictor's on > 99% of
    pixels, the bound of JAX's ``TestQuantizedUNetPP`` on its own init (the
    port's default init is the same distribution)."""
    torch.manual_seed(14)
    model = get_model("unet_pp_s", n_classes=3, **kw).eval()
    x = np.random.default_rng(15).random((2, 64, 64, 1), dtype=np.float32)
    q = Predictor(model, device="cpu", quantize=True)
    masks = q.predict_array(x)
    assert q._qparams is not None and "s_nodes" in q._qparams and "x0_4" in q._qparams
    assert ("up0_1" in q._qparams) != model.bilinear
    assert (masks == Predictor(model, device="cpu").predict_array(x)).mean() > 0.99


# -- serving, export, ONNX, CLIs --------------------------------------------------


def test_tiled_matches_jax():
    """Above tile_threshold, tiles of 64 with a 48 halo, against JAX's tiled
    serving of the same weights: equal masks where the top-two margin of
    the port's logits exceeds 1e-4."""
    model, params, state = _seeded(seed=11, centre=True)
    x = np.random.default_rng(5).random((1, 96, 160, 1), dtype=np.float32)
    got = Predictor(model, device="cpu", tile=64, tile_halo=48,
                    tile_threshold=64 * 64).predict_array(x)
    # JAX serves UNet++ in its wide layout (its NHWC apply takes no folded
    # params); the function is the same
    jp = JaxPredictor(_jax().with_options(layout="auto"), jax.tree.map(jnp.asarray, params),
                      jax.tree.map(jnp.asarray, state), tile=64, tile_halo=48,
                      tile_threshold=64 * 64)
    want = np.asarray(jp.predict_array(x))
    margin = top2_margin(tiled_logits(fold_bn(model), torch.from_numpy(x), 64, 48)).numpy()
    ok = margin >= 1e-4
    assert ok.mean() > 0.99 and len(np.unique(want)) >= 2
    np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("kw", [{}, dict(bilinear=True, deep_supervision=True)],
                         ids=["convt", "bilinear_deep_supervision"])
def test_onnx_bytes_equal_jax(kw, tmp_path):
    """The port's writer emits JAX build_unet_pp_onnx's bytes, and the graph
    run by run_with_torch gives the eval forward's logits."""
    model, params, state = _seeded(seed=12, **kw)
    got = TO.export_onnx(model, str(tmp_path / "p.onnx"))
    want = JO.export_onnx(_jax(**kw), params, state, str(tmp_path / "j.onnx"))
    assert got == want
    x = np.random.default_rng(6).random((1, 1, 48, 64), np.float32)
    y = TO.run_with_torch(got, x)
    np.testing.assert_allclose(y, logits_of(model, x.transpose(0, 2, 3, 1)).transpose(0, 3, 1, 2),
                               rtol=1e-4, atol=1e-4)


def test_program_serves_on_the_cpu():
    """A static .pt2 program of unet_pp_s (BN folded) served by
    ExportedPredictor: the live Predictor's masks.  (A program with symbolic
    H and W takes ~10 s to trace here; chip_smoke's C2 and C4 serve those.)"""
    model, _, _ = _seeded(seed=13, centre=True)
    data = export_program(model, device="cpu", example_hw=(48, 80), dynamic_batch=False,
                          dynamic_hw=False)
    program = ExportedPredictor(data, device="cpu", tile_threshold=0, batch_size=2)
    x = np.random.default_rng(9).random((2, 48, 80, 1), dtype=np.float32)
    np.testing.assert_array_equal(program.predict_array(x),
                                  Predictor(model, device="cpu").predict_array(x))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A unet_pp_s .npz (3 classes) and a directory of two 64x64 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("pp")
    model, _, _ = _seeded(seed=14, centre=True)
    TC.save_checkpoint(str(root / "pp.npz"), model)
    (root / "pngs").mkdir()
    rng = np.random.default_rng(7)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
            root / "pngs" / f"{name}.png")
    return model, root


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_predict_cli_serves_unet_pp(checkpoint, int8):
    from PIL import Image

    from unet_medical_image_contour_segmentation_torch.engine.predict import (
        collect_image_files,
        mask_to_image,
    )

    model, root = checkpoint
    out = root / f"out_{int8}"
    assert predict_cli.main(["-m", str(root / "pp.npz"), "-i", str(root / "pngs"), "-o",
                             str(out), "--arch", "unet_pp_s", "--device", "cpu",
                             "--no-postprocess", *(["--int8"] if int8 else [])]) == 0
    want = Predictor(model, device="cpu", quantize=int8).predict_paths(
        collect_image_files(str(root / "pngs")), postprocess=False, save=False)
    for path, mask in want.items():
        saved = np.asarray(Image.open(out / os.path.basename(path)))
        np.testing.assert_array_equal(saved, np.asarray(mask_to_image(mask)))


def test_export_cli_writes_unet_pp_onnx(checkpoint, tmp_path):
    _, root = checkpoint
    assert export_cli.main(["-m", str(root / "pp.npz"), "--arch", "unet_pp_s", "--device",
                            "cpu", "-o", str(tmp_path / "pp.onnx")]) == 0
    assert TO.parse_model((tmp_path / "pp.onnx").read_bytes())["opset"] == 11


def test_train_cli_trains_unet_pp(tmp_path, monkeypatch):
    """One epoch of unet_pp_s (3 classes, remat) through the train CLI on
    synthetic PNGs: the final checkpoint holds its step and optimizer state."""
    from PIL import Image

    rng = np.random.default_rng(8)
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
                           "--model", "unet_pp_s", "--remat", "--scale", "0.5", "--no-amp",
                           "--no-save-val-predictions", "--no-val-postprocess",
                           "--device", "cpu"]) == 0
    ck = TC.load_checkpoint(str(tmp_path / "model_epoch1.npz"))
    # 2 slices, each in its 4 rotations, in batches of 2
    assert ck["step"] == 4 and "x0_4" in ck["params"] and ck["opt_state"] is not None
