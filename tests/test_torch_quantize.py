"""The port's int8 serving against the JAX package's ``models/quantize.py``,
f32 on the CPU, seeded numpy inputs.

The int8 conv (the kernel's plain version on the CPU) equals JAX's
``conv_wide_int8`` / ``conv_wide_split_int8`` and ``_qconv`` exactly; the
calibration, ``build_qparams`` and the int8 forward are compared per UNet
variant on the same weights (chip_smoke's seeded JAX-layout pytrees, BN off
identity); the Predictor reproduces JAX ``tests/test_quantize.py``'s
routing (auto-calibration, ``INT8_MIN_BATCH``, binary head, tiled,
non-16-multiple shapes); a calibration JSON crosses between the packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.engine import predict as TPRED
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.kernels import conv3x3_int8 as K8
from unet_medical_image_contour_segmentation_torch.models import quantize as TQ
from unet_medical_image_contour_segmentation_torch.models.fold_bn import fold_bn
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    qparams_from_jax,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_tpu.engine.predict import Predictor as JaxPredictor
from unet_medical_image_contour_segmentation_tpu.models import quantize as JQ
from unet_medical_image_contour_segmentation_tpu.models.fold_bn import fold_params
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_s, unet_sa, unet_t
from unet_medical_image_contour_segmentation_tpu.ops import wide as W

WIDTHS = {"unet_s": (16, 32, 64, 128, 256), "unet_sa": (16, 32, 64, 128, 256),
          "unet_t": (8, 16, 32, 64, 128)}
JAX_MODELS = {"unet_s": unet_s, "unet_sa": unet_sa, "unet_t": unet_t}
VARIANTS = [("unet_s", False), ("unet_s", True), ("unet_sa", False), ("unet_t", False)]


def _int8(rng, shape):
    return rng.integers(-127, 128, shape, dtype=np.int8)


# -- the conv and its epilogue ------------------------------------------------


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 16, 24), 1, 16), ((1, 13, 9), 24, 40), ((2, 8, 16), 64, 72), ((1, 4, 4), 1024, 8),
])
def test_int8_sums_equal_jax_conv_wide_int8(shape, cin, cout):
    """Exact int32 sums, against JAX's int8 x int8 -> int32 conv (bw 1)."""
    rng = np.random.default_rng(0)
    x, w = _int8(rng, (*shape, cin)), _int8(rng, (3, 3, cin, cout))
    want = np.asarray(W.conv_wide_int8(jnp.asarray(x), jnp.asarray(w), 1))
    got = K8.conv3x3_int8_sums(torch.from_numpy(x), K8.pack_weight(torch.from_numpy(w)), cout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_sums_of_a_concat_equal_jax_split_conv():
    """The decoder's int8 [skip, up] concat through one conv equals JAX's
    kernel-split int32 partial convs in the wide layout (bw 4)."""
    rng = np.random.default_rng(1)
    bw, c1, c2, cout = 4, 16, 16, 32
    xs = [_int8(rng, (2, 8, 32, c)) for c in (c1, c2)]
    w = _int8(rng, (3, 3, c1 + c2, cout))
    want = W.unpack(W.conv_wide_split_int8([W.pack(jnp.asarray(x), bw) for x in xs], [c1, c2],
                                           jnp.asarray(w), bw), bw)
    cat = torch.from_numpy(np.concatenate(xs, axis=-1))
    got = K8.conv3x3_int8_sums(cat, K8.pack_weight(torch.from_numpy(w)), cout)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("requant", [True, False])
def test_qconv_epilogue_equals_jax(requant):
    """``_qconv`` requant (int8) and dequant (f32) against JAX's, bit for bit."""
    rng = np.random.default_rng(2)
    cin, cout = 32, 48
    x, w = _int8(rng, (2, 12, 20, cin)), _int8(rng, (3, 3, cin, cout))
    mul = (rng.uniform(0.5, 1.5, cout) * 60 / (np.sqrt(9 * cin) * 73.0 ** 2)).astype(np.float32)
    badd = rng.normal(0, 30, cout).astype(np.float32)
    want = np.asarray(JQ._qconv(jnp.asarray(x), None, {"w": jnp.asarray(w), "mul": mul,
                                                        "badd": badd}, 1, requant=requant))
    entry = {"w": K8.pack_weight(torch.from_numpy(w)), "mul": torch.from_numpy(mul),
             "badd": torch.from_numpy(badd)}
    got = TQ._qconv(torch.from_numpy(x), entry, torch.int8 if requant else torch.float32)
    assert got.dtype == (torch.int8 if requant else torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    if requant:
        assert (want == 0).any() and (want == 127).any()


# -- calibration, build_qparams and the forward, per UNet variant --------------


@pytest.fixture(scope="module", params=VARIANTS, ids=lambda v: f"{v[0]}-bilinear{v[1]}")
def variant(request):
    """JAX's side of one variant on seeded weights: the f32 fold, the amax
    dict, the qparams and the int8 logits at (2, 64, 64); and the port's
    model carrying the same weights.

    The int8 forward runs eagerly, as the JAX package's own tests run it:
    under ``jax.jit`` XLA contracts ``_qconv``'s multiply and add into one
    FMA, one rounding where the source (and the port's kernel) has two, so a
    requant lands one LSB off where the two differ across a .5 boundary
    (seed 0: one element of inc.conv2 at (1, 64, 64)), and these random
    weights carry such a flip far (6% of the largest logit)."""
    name, bilinear = request.param
    params, state = random_unet_params(0, WIDTHS[name], bilinear=bilinear,
                                       attention=name == "unet_sa")
    jm = JAX_MODELS[name](bilinear=bilinear)
    x = np.random.default_rng(3).random((2, 64, 64), dtype=np.float32)
    fp = fold_params(params, state)
    amax = JQ.calibrate_amax(jm, fp, x)
    qp = JQ.build_qparams(jm, fp, amax)
    logits = np.asarray(JQ.apply_wide_int8(jm, qp, x)[0])
    model = get_model(name, bilinear=bilinear)
    model.load_state_dict(state_dict_from_jax(params, state))
    return dict(x=x, amax=amax, qp=qp, logits=logits, model=model.eval())


def test_calibrate_amax_matches_jax(variant):
    tree = TQ.folded_tree(fold_bn(variant["model"]))
    got = TQ.calibrate_amax(tree, torch.from_numpy(variant["x"]))
    want = variant["amax"]
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_build_qparams_matches_jax(variant):
    """From JAX's amax dict and the port's f32 fold of the same weights:
    mul / badd to 1e-6 (badd, a folded bias beta - mean * scale, may cancel
    to near 0, so its atol is 1e-6 of the tensor's largest element); int8
    weights equal but for 1-LSB round-half ties."""
    got = TQ.build_qparams(TQ.folded_tree(fold_bn(variant["model"])), variant["amax"])
    want = qparams_from_jax(variant["qp"])
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert flat_got.keys() == flat_want.keys()
    flips = 0
    for k, w in flat_want.items():
        g = flat_got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == torch.int8:
            d = (g.int() - w.int()).abs()
            assert d.max() <= 1, k
            flips += int(d.sum())
        else:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * w.abs().max().item(),
                                       msg=k)
    assert flips <= 2


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_apply_int8_matches_jax(variant):
    """JAX's qparams carried in: the logits agree to 1e-4 of their largest
    magnitude on >= 99.9% of entries (the float pieces round differently,
    and a requant of the upsample can then flip one LSB), and the classes
    agree wherever the top-two margin exceeds 1e-3."""
    want = variant["logits"]
    got = TQ.apply_int8(qparams_from_jax(variant["qp"]), torch.from_numpy(variant["x"]))
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert (np.abs(got - want) <= 1e-4 * np.abs(want).max()).mean() >= 0.999
    top2 = np.sort(want, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 1e-3
    np.testing.assert_array_equal(got.argmax(-1)[decided], want.argmax(-1)[decided])


# -- the Predictor (JAX tests/test_quantize.py:112-229) --------------------------


def _model(name="unet_t", n_classes=3, seed=2):
    params, state = random_unet_params(seed, WIDTHS[name], n_classes=n_classes,
                                       attention=name == "unet_sa")
    model = get_model(name, n_classes=n_classes)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model


def _images(seed, b, h, w=None):
    return np.random.default_rng(seed).random((b, h, w or h, 1), dtype=np.float32)


def test_auto_calibration_and_agreement():
    model = _model()
    pq, pf = Predictor(model, device="cpu", quantize=True), Predictor(model, device="cpu")
    x = _images(6, 2, 64)
    assert pq._qparams is None
    got = pq.predict_array(x)
    assert pq._qparams is not None  # calibrated on the first batch
    assert (got == pf.predict_array(x)).mean() > 0.99
    qp = pq._qparams
    pq.predict_array(x)
    assert pq._qparams is qp  # the second call reuses the calibration


def test_int8_min_batch_gate(monkeypatch):
    """unet_sa below INT8_MIN_BATCH serves the float program, bit-equal to a
    float Predictor; at 4 it serves int8.  unet_t has no gate."""
    calls = []
    monkeypatch.setattr(TPRED, "apply_int8", lambda *a: calls.append(a[1].shape) or
                        TQ.apply_int8(*a))
    model = _model("unet_sa", seed=11)
    pq, pf = Predictor(model, device="cpu", quantize=True), Predictor(model, device="cpu")
    assert pq._int8_min_batch() == 4
    pq.calibrate(_images(8, 2, 64)[..., 0])
    for b in (1, 2):
        small = _images(9 + b, b, 64)
        np.testing.assert_array_equal(pq.predict_array(small), pf.predict_array(small))
    assert calls == []
    pq.predict_array(_images(12, 4, 64))
    assert calls == [(4, 64, 64, 1)]
    assert Predictor(_model(), device="cpu", quantize=True)._int8_min_batch() == 1


def test_predict_array_gates_int8_on_the_whole_array(monkeypatch):
    """As JAX's ``predict_array``: the whole array's B decides the program.
    unet_sa, 5 images at batch_size 4: both chunks serve int8 (calibrated on
    the first 4 images); 3 images at batch_size 2 serve no int8 at all."""
    calls = []
    monkeypatch.setattr(TPRED, "apply_int8", lambda *a: calls.append(a[1].shape) or
                        TQ.apply_int8(*a))
    model = _model("unet_sa", seed=11)
    x = _images(15, 5, 64)
    pq = Predictor(model, device="cpu", quantize=True, batch_size=4)
    pq.predict_array(x)
    assert calls == [(4, 64, 64, 1), (1, 64, 64, 1)]
    ref = Predictor(model, device="cpu", quantize=True)
    ref.calibrate(x[:4])
    assert pq._amax == ref._amax
    calls.clear()
    small = Predictor(model, device="cpu", quantize=True, batch_size=2)
    np.testing.assert_array_equal(small.predict_array(x[:3]),
                                  Predictor(model, device="cpu").predict_array(x[:3]))
    assert calls == [] and small._qparams is not None


def test_binary_head():
    pq = Predictor(_model(n_classes=1), device="cpu", quantize=True)
    out = pq.predict_array(_images(7, 1, 32))
    assert pq._qparams is not None
    assert out.shape == (1, 32, 32) and set(np.unique(out)) <= {0, 1}


def test_tiled_path_quantized():
    """64^2 above a 32^2 threshold: tiled (tile 32, halo 16) and int8; the
    same windows through the float tiled path agree on >= 99%."""
    model = _model()
    pq = Predictor(model, device="cpu", quantize=True, tile=32, tile_halo=16,
                   tile_threshold=32 * 32)
    pf = Predictor(model, device="cpu", tile=32, tile_halo=16, tile_threshold=32 * 32)
    x = _images(8, 1, 64)
    got, want = pq.predict_array(x), pf.predict_array(x)
    assert pq._qparams is not None
    assert got.shape == want.shape == (1, 64, 64)
    assert (got == want).mean() > 0.99


def test_non_16_multiple_shape_serves_float():
    """24^2: the 16-multiple cut (16) is under 32, so calibration is skipped
    and the float program serves, bit-equal; after a calibration on 64^2,
    24^2 still serves float (the int8 program needs 16-multiples)."""
    model = _model()
    pq, pf = Predictor(model, device="cpu", quantize=True), Predictor(model, device="cpu")
    x = _images(9, 1, 24)
    want = pf.predict_array(x)
    np.testing.assert_array_equal(pq.predict_array(x), want)
    assert pq._qparams is None
    pq.calibrate(_images(10, 1, 64))
    np.testing.assert_array_equal(pq.predict_array(x), want)


def test_calibration_needs_quantize_true():
    pf = Predictor(_model(), device="cpu")
    with pytest.raises(ValueError, match="quantize=True"):
        pf._set_amax({"x": 1.0})


def test_calibration_json_crosses_packages(tmp_path):
    """A calibration saved by either package loads in the other, and the two
    build the same int8 weights from it."""
    params, state = random_unet_params(4, WIDTHS["unet_t"])
    jm = unet_t(1, 3)
    jp = JaxPredictor(jm, jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, state),
                      quantize=True)
    jp.calibrate(_images(13, 2, 64)[..., 0])
    jp.save_calibration(str(tmp_path / "jax.json"))
    model = get_model("unet_t")
    model.load_state_dict(state_dict_from_jax(params, state))
    port = Predictor(model, device="cpu", quantize=True)
    port.load_calibration(str(tmp_path / "jax.json"))
    assert port._amax == jp._amax
    w_port = port._qparams["down2"]["conv1"]["w"]
    w_jax = K8.pack_weight(torch.from_numpy(np.array(jp._qparams["down2"]["conv1"]["w"])))
    assert (w_port.int() - w_jax.int()).abs().max() <= 1

    port.calibrate(_images(14, 2, 64))
    port.save_calibration(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_text().startswith('{\n "down1.c1"')
    jp.load_calibration(str(tmp_path / "port.json"))
    assert jp._amax == port._amax
