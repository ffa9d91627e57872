"""YOLOv8-seg's int8 path in the port against the JAX package's
``models/quantize.py`` (``_forward_yolo``, ``build_qparams_yolo``), f32 on
the CPU, on seeded numpy weights in the JAX layout (``chip_smoke``'s
``random_params_like``) carried into the port.

JAX's walker runs eagerly (``jax.disable_jit()``), as
``tests/test_torch_quantize.py`` runs the UNet's: under ``jax.jit`` XLA
contracts a multiply and an add into one FMA where the source (and the
port) rounds twice, and an int8 requant then lands one step off.  Each JAX
reference is computed once per class count in a module fixture.

Tolerances: the CBS fold to rtol 1e-6 (the two folds' f32 divisions may
differ by an ulp); the calibration taps to rtol 1e-5; ``build_qparams_yolo``
on the same folded tree exactly; the SiLU epilogues to rtol 1e-6 in float
(torch's and XLA's f32 sigmoids may differ by an ulp) and, in int8, by at
most 1 on at most 1e-4 of the elements; the int8 sums, the residual
requant-add and the int8 pool exactly; the whole int8 forward to argmax
(or, for one class, sign) agreement >= 99% and logit cosine > 0.999; the
int8 Predictor's masks >= 99% of JAX's int8 Predictor's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seeded_model
from unet_medical_image_contour_segmentation_torch.cli import export_model as export_cli
from unet_medical_image_contour_segmentation_torch.cli import predict as predict_cli
from unet_medical_image_contour_segmentation_torch.engine import checkpoint as TC
from unet_medical_image_contour_segmentation_torch.engine.export import export_program_int8
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    ExportedPredictor,
    Predictor,
    collect_image_files,
    mask_to_image,
)
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3_int8 as K8
from unet_medical_image_contour_segmentation_torch.models import quantize as TQ
from unet_medical_image_contour_segmentation_torch.models.fold_bn import (
    fold_for_quantize,
    fold_yolo,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    qparams_from_jax,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.models import quantize as JQ
from unet_medical_image_contour_segmentation_tpu.models.fold_bn import fold_yolo_params
from unet_medical_image_contour_segmentation_tpu.models.unet import get_model as jax_get_model
from unet_medical_image_contour_segmentation_tpu.ops import wide as W

SCOPES = ("proto", "full")
MIN_AGREEMENT = 0.99
MIN_COSINE = 0.999


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Test files run in parallel worker processes; one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(n_classes, **kw):
    return jax_get_model("yolov8_seg_s", n_classes=n_classes, **kw)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tensors(tree):
    """A numpy / jax pytree -> the same dict of f32 CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _classes(logits: np.ndarray) -> np.ndarray:
    """sigmoid > 0.5 for one channel, else the argmax (the Predictor's rule)."""
    return logits[..., 0] > 0 if logits.shape[-1] == 1 else logits.argmax(-1)


def _agreement(got: np.ndarray, want: np.ndarray):
    cos = float((got * want).sum() / (np.linalg.norm(got) * np.linalg.norm(want) + 1e-12))
    return float((_classes(got) == _classes(want)).mean()), cos


@pytest.fixture(scope="module", params=[1, 3], ids=["binary", "3class"])
def case(request):
    """JAX's side for one class count on seeded weights: the CBS fold, the
    amax dict, the qparams and the int8 logits of both scopes at (2, 64,
    64), all eager; and the port's model carrying the same weights."""
    n = request.param
    model = seeded_model("yolov8_seg_s", 20 + n, n_classes=n)
    params, state, _ = params_from_state_dict(model.state_dict())
    jm = _jax(n)
    x = np.random.default_rng(30 + n).random((2, 64, 64), dtype=np.float32)
    with jax.disable_jit():
        fp = fold_yolo_params(params, state)
        amax = JQ.calibrate_amax(jm, fp, x)
        qp = {s: JQ.build_qparams_yolo(jm, fp, amax, scope=s) for s in SCOPES}
        logits = {s: np.asarray(JQ.apply_wide_int8(jm, qp[s], x)[0]) for s in SCOPES}
    return dict(n=n, model=model, params=params, state=state, x=x, fp=fp, amax=amax, qp=qp,
                logits=logits)


def test_fold_yolo_matches_jax(case):
    """Every CBS folds to JAX's {w, b}; the ConvT ups and the head pass
    through; the tree has JAX's keys."""
    got = _flatten(TQ.folded_tree(fold_yolo(case["model"], torch.float32)))
    want = _flatten(case["fp"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_fold_yolo_serves_the_live_forward(case):
    """The folded copy's own forward is the live-BN eval forward's."""
    model = case["model"]
    x = torch.from_numpy(case["x"])
    with torch.no_grad():
        torch.testing.assert_close(fold_yolo(model)(x), model(x), rtol=1e-4, atol=1e-5)
    with pytest.raises(KeyError):
        fold_yolo(get_model("unet_t"))


def test_calibration_taps_match_jax(case):
    tree = TQ.folded_tree(fold_for_quantize(case["model"]))
    got, want = TQ.calibrate_amax(tree, torch.from_numpy(case["x"])), case["amax"]
    assert set(got) == set(want) and len(want) == 56
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("scope", SCOPES)
def test_build_qparams_yolo_matches_jax(case, scope):
    """On JAX's folded tree and amax dict: the same keys, int8 weights
    equal to JAX's in the port's forms, every scale and float tensor equal
    in f32."""
    got = _flatten(TQ.build_qparams_yolo(_tensors(case["fp"]), case["amax"], scope=scope))
    want = _flatten(qparams_from_jax(case["qp"][scope]))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == (torch.int8 if k.endswith("/w") and g.dtype == torch.int8
                           else torch.float32), k
        assert torch.equal(g.to(w.dtype), w), k
    n_int8 = sum(1 for v in got.values() if v.dtype == torch.int8)
    assert n_int8 == (3 if scope == "proto" else 42)


def test_build_qparams_yolo_refuses_other_scopes(case):
    with pytest.raises(ValueError, match="scope"):
        TQ.build_qparams_yolo(_tensors(case["fp"]), case["amax"], scope="backbone")


# -- per op --------------------------------------------------------------------


def _sums(seed, shape):
    rng = np.random.default_rng(seed)
    acc = rng.integers(-60000, 60000, shape, dtype=np.int32)
    cout = shape[-1]
    mul = rng.uniform(0.5, 1.5, cout).astype(np.float32) * 1e-4
    badd = rng.normal(0, 1, cout).astype(np.float32)
    return acc, mul, badd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_silu_dequant_epilogue_matches_jax(dtype):
    """The kernel's plain SiLU dequant on int32 sums against JAX
    ``_forward_yolo``'s cbs arithmetic, cast to the compute dtype."""
    acc, mul, badd = _sums(40, (2, 16, 16, 64))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    with jax.disable_jit():
        yf = jnp.asarray(acc).astype(jnp.float32) * mul + badd
        want = np.asarray((yf * jax.nn.sigmoid(yf)).astype(jdt).astype(jnp.float32))
    got = K8.epilogue(torch.from_numpy(acc), torch.from_numpy(mul), torch.from_numpy(badd),
                      dtype, act="silu")
    assert got.dtype == dtype and (want < 0).any() and (want > 1).any()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6, atol=0)


def test_silu_requant_epilogue_matches_jax():
    """SiLU then ``_requant_signed`` onto [-127, 127]: off by at most 1 on
    at most 1e-4 of the elements (an ulp of the sigmoid at a .5 tie)."""
    acc, mul, badd = _sums(41, (2, 16, 16, 64))
    inv_s = np.float32(127 / 3.0)
    with jax.disable_jit():
        yf = jnp.asarray(acc).astype(jnp.float32) * mul + badd
        want = np.asarray(JQ._requant_signed(yf * jax.nn.sigmoid(yf), jnp.float32(inv_s)))
    got = K8.epilogue(torch.from_numpy(acc), torch.from_numpy(mul), torch.from_numpy(badd),
                      torch.int8, act="silu", inv_s=torch.tensor(inv_s)).numpy()
    assert got.dtype == np.int8 and want.min() < 0 and want.max() == 127
    diff = np.abs(got.astype(np.int32) - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("out", ["int8", "bf16"])
def test_silu_conv_plain_version(out):
    """``conv3x3_int8(act="silu")`` on the CPU is the exact int32 sums through
    the SiLU epilogue, for a Cin < 16 input too (padded, as on the card)."""
    rng = np.random.default_rng(42)
    for cin in (8, 32):
        x = torch.from_numpy(rng.integers(-127, 128, (1, 9, 13, cin), dtype=np.int8))
        w = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, 24), dtype=np.int8))
        wp, mul, badd = K8.pack_weight(w), torch.full((24,), 2e-5), torch.zeros(24)
        out_dtype = torch.int8 if out == "int8" else torch.bfloat16
        inv_s = torch.tensor(40.0) if out == "int8" else None
        got = K8.conv3x3_int8(x, wp, mul, badd, out_dtype, act="silu", inv_s=inv_s)
        want = K8.epilogue(K8.conv3x3_int8_sums(x, wp, 24), mul, badd, out_dtype, "silu", inv_s)
        assert torch.equal(got, want)


def test_silu_conv_refuses_misuse():
    x = torch.zeros((1, 4, 4, 16), dtype=torch.int8)
    wp = K8.pack_weight(torch.zeros((3, 3, 16, 16), dtype=torch.int8))
    mul = badd = torch.zeros(16)
    with pytest.raises(ValueError, match="inv_s"):
        K8.conv3x3_int8(x, wp, mul, badd, torch.int8, act="silu")
    with pytest.raises(ValueError, match="inv_s"):
        K8.conv3x3_int8(x, wp, mul, badd, torch.int8, inv_s=torch.tensor(1.0))
    with pytest.raises(ValueError, match="act"):
        K8.conv3x3_int8(x, wp, mul, badd, torch.bfloat16, act="gelu")


def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("hw,cin,cout", [((16, 16), 1, 32), ((9, 14), 32, 64), ((8, 8), 64, 24)])
def test_stride2_sums_match_jax(hw, cin, cout):
    """The stride-2 3x3 int8 conv (the stem's Cin 1: K 9 padded to 16) as an
    int8 matrix product on the im2col rows, against JAX's
    ``conv_wide_int8(stride=2)``: exact."""
    rng = np.random.default_rng(43)
    x, w = _int8(rng, (2, *hw, cin)), _int8(rng, (3, 3, cin, cout))
    want = np.asarray(W.conv_wide_int8(jnp.asarray(x), jnp.asarray(w), 1, stride=2))
    wm = TQ.int8_conv_weight(torch.from_numpy(w), stride=2)
    assert wm.shape == (-(-cout // 8) * 8, -(-9 * cin // 8) * 8)
    got = TQ._int8_conv_sums(torch.from_numpy(x), wm, 3, 2)[..., :cout]
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("cin,cout", [(64, 32), (96, 128), (20, 12)])
def test_1x1_sums_match_jax(cin, cout):
    """The 1x1 int8 conv as one (B*H*W, Cin) x (Cin, Cout) product against
    JAX's ``conv1x1_wide_int8``: exact."""
    rng = np.random.default_rng(44)
    x, w = _int8(rng, (2, 8, 12, cin)), _int8(rng, (1, 1, cin, cout))
    want = np.asarray(W.conv1x1_wide_int8(jnp.asarray(x), jnp.asarray(w), 1))
    got = TQ._int8_conv_sums(torch.from_numpy(x), TQ.int8_conv_weight(torch.from_numpy(w)), 1,
                             1)[..., :cout]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("yf_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_requant_add_matches_jax(yf_dtype):
    """The bottleneck's residual requant-add: exact on the same inputs."""
    rng = np.random.default_rng(45)
    t = _int8(rng, (2, 8, 8, 32))
    yf = torch.from_numpy(rng.normal(0, 2, (2, 8, 8, 32)).astype(np.float32)).to(yf_dtype)
    res_s, add_inv_s = np.float32(0.031), np.float32(127 / 5.0)
    with jax.disable_jit():
        jyf = jnp.asarray(yf.float().numpy()).astype(
            jnp.float32 if yf_dtype == torch.float32 else jnp.bfloat16)
        want = np.asarray(JQ._requant_signed(
            jnp.asarray(t).astype(jnp.float32) * res_s + jyf.astype(jnp.float32), add_inv_s))
    got = TQ._requant_add(torch.from_numpy(t), yf, torch.tensor(res_s), torch.tensor(add_inv_s))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_sppf_pool_matches_jax():
    rng = np.random.default_rng(46)
    x = _int8(rng, (2, 7, 9, 16))
    x[0, :3, :3] = -127  # a corner window of the lowest values
    want = np.asarray(JQ._maxpool5_same_int8(jnp.asarray(x)))
    got = TQ._maxpool5_same_int8(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# -- the whole forward -----------------------------------------------------------


@pytest.mark.parametrize("scope", SCOPES)
def test_apply_int8_matches_jax(case, scope):
    """The port's fold and ``build_qparams_yolo`` from JAX's amax, then
    ``apply_int8``, against JAX's eager ``apply_wide_int8``."""
    tree = TQ.folded_tree(fold_for_quantize(case["model"]))
    qp = TQ.build_qparams_yolo(tree, case["amax"], scope=scope)
    got = TQ.apply_int8(qp, torch.from_numpy(case["x"]))
    want = case["logits"][scope]
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 64, 64, case["n"])
    agree, cos = _agreement(got.numpy(), want)
    assert agree >= MIN_AGREEMENT and cos > MIN_COSINE, (agree, cos)


@pytest.mark.parametrize("scope", SCOPES)
def test_int8_meets_jax_float_criteria(scope):
    """JAX ``tests/test_quantize.py::TestQuantizedYolo::test_close_to_float``
    on the port: yolov8_seg_s (3 classes, bf16 compute) with JAX's own
    initial weights, calibrated and built by the port, against its float
    eval forward: cosine > 0.999 and argmax agreement > 0.99."""
    jm = _jax(3, compute_dtype=jnp.bfloat16)
    params, state = jm.init(jax.random.PRNGKey(7))
    model = get_model("yolov8_seg_s", n_classes=3, compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict_from_jax(params, state))
    model.eval()
    x = torch.from_numpy(np.random.RandomState(11).rand(2, 64, 64).astype(np.float32))
    with torch.no_grad():
        ref = model(x).numpy()
    tree = TQ.folded_tree(fold_for_quantize(model))
    qp = TQ.build_qparams_yolo(tree, TQ.calibrate_amax(tree, x, torch.bfloat16), scope=scope)
    ql = TQ.apply_int8(qp, x, torch.bfloat16).numpy()
    agree, cos = _agreement(ql, ref)
    assert cos > MIN_COSINE and agree > MIN_AGREEMENT, (agree, cos)


# -- serving -------------------------------------------------------------------


def _jax_predictor(n_classes, params, state, **kw):
    return JaxPredictor(_jax(n_classes, layout="auto"), jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, state), quantize=True, **kw)


def test_predictor_int8_matches_jax(case, tmp_path):
    """Dense: the port's int8 Predictor (first-batch calibration on the CBS
    fold, proto scope) against JAX's, masks >= 99%; the port loads JAX's
    saved calibration JSON and serves the same masks as from its own."""
    x = np.random.default_rng(50).random((2, 64, 96, 1), dtype=np.float32)
    jp = _jax_predictor(case["n"], case["params"], case["state"])
    want = np.asarray(jp.predict_array(x))
    jp.save_calibration(str(tmp_path / "jax.json"))
    pq = Predictor(case["model"], device="cpu", quantize=True)
    got = pq.predict_array(x)
    assert "stem" in pq._qparams and "s_x" not in pq._qparams  # proto scope
    assert pq._qparams["p_c3"]["w"].dtype == torch.int8
    assert (got == want).mean() >= MIN_AGREEMENT
    loaded = Predictor(case["model"], device="cpu", quantize=True)
    loaded.load_calibration(str(tmp_path / "jax.json"))
    assert loaded._amax == json.loads((tmp_path / "jax.json").read_text())
    assert (loaded.predict_array(x) == want).mean() >= MIN_AGREEMENT


def test_tiled_int8_matches_jax():
    """Tiled int8 above tile_threshold: a 96x160 image at tile 64, halo 48
    (windows of 160, a multiple of 32), 3 classes, against JAX's tiled
    int8."""
    model = seeded_model("yolov8_seg_s", 25, n_classes=3)
    params, state, _ = params_from_state_dict(model.state_dict())
    x = np.random.default_rng(51).random((1, 96, 160, 1), dtype=np.float32)
    kw = dict(tile=64, tile_halo=48, tile_threshold=64 * 64)
    want = np.asarray(_jax_predictor(3, params, state, **kw).predict_array(x))
    pq = Predictor(model, device="cpu", quantize=True, **kw)
    got = pq.predict_array(x)
    assert pq._qparams is not None and got.shape == (1, 96, 160)
    assert (got == want).mean() >= MIN_AGREEMENT


def test_int8_program_serves_the_live_masks(case):
    """A static int8 .pt2 program of the proto scope's qparams served by
    ExportedPredictor: the live int8 Predictor's masks, exactly."""
    x = np.random.default_rng(52).random((2, 64, 64, 1), dtype=np.float32)
    pq = Predictor(case["model"], device="cpu", quantize=True, tile_threshold=0)
    want = pq.predict_array(x)
    data = export_program_int8(case["model"], pq._qparams, example_hw=(64, 64),
                               dynamic_batch=False)
    got = ExportedPredictor(data, device="cpu", tile_threshold=0).predict_array(x)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A yolov8_seg_s .npz (binary) and a directory of two 64x64 PNGs."""
    from PIL import Image

    root = tmp_path_factory.mktemp("yolo_int8")
    model = seeded_model("yolov8_seg_s", 24)
    TC.save_checkpoint(str(root / "y.npz"), model)
    (root / "pngs").mkdir()
    rng = np.random.default_rng(53)
    for name in ("a", "b"):
        Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
            root / "pngs" / f"{name}.png")
    return model, root


def test_predict_cli_serves_yolo_int8(checkpoint):
    """``--int8 --int8-scales``: calibrates on the first batch, saves the
    JSON, and writes the int8 Predictor's masks."""
    from PIL import Image

    model, root = checkpoint
    out, scales = root / "out", root / "scales.json"
    assert predict_cli.main(["-m", str(root / "y.npz"), "-i", str(root / "pngs"), "-o",
                             str(out), "--arch", "yolov8_seg_s", "--classes", "1", "--device",
                             "cpu", "--no-postprocess", "--int8", "--int8-scales",
                             str(scales)]) == 0
    assert "p_c3.in" in json.loads(scales.read_text())
    pq = Predictor(model, device="cpu", quantize=True)
    pq.load_calibration(str(scales))
    want = pq.predict_paths(collect_image_files(str(root / "pngs")), postprocess=False,
                            save=False)
    for path, mask in want.items():
        saved = np.asarray(Image.open(out / os.path.basename(path)))
        np.testing.assert_array_equal(saved, np.asarray(mask_to_image(mask)))


def test_export_cli_writes_yolo_int8_program(checkpoint, tmp_path):
    """``--int8 --calib`` exports the int8 program at ``--int8-hw`` and its
    sanity forward equals the live int8 forward's classes."""
    _, root = checkpoint
    out = tmp_path / "y.int8.pt2"
    assert export_cli.main(["-m", str(root / "y.npz"), "--arch", "yolov8_seg_s", "--classes",
                            "1", "--device", "cpu", "--int8", "--calib", str(root / "pngs"),
                            "--int8-hw", "64", "64", "-o", str(out)]) == 0
    masks = ExportedPredictor.from_file(str(out), device="cpu", tile_threshold=0).predict_array(
        np.random.default_rng(54).random((1, 64, 64, 1), dtype=np.float32))
    assert masks.shape == (1, 64, 64) and set(np.unique(masks)) <= {0, 1}
