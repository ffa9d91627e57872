"""The port's Dice, boundary, connected-component and compound losses against
the JAX package's, value and gradient, on the CPU in f32 (rtol 1e-5, atol
1e-6: the same f32 arithmetic summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.losses import boundary as TB
from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.losses import connected_component as TCC
from unet_medical_image_contour_segmentation_torch.losses import dice as TD
from unet_medical_image_contour_segmentation_tpu.losses import boundary as JB
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
from unet_medical_image_contour_segmentation_tpu.losses import connected_component as JCC
from unet_medical_image_contour_segmentation_tpu.losses import dice as JD

TOL = dict(rtol=1e-5, atol=1e-6)


def _probs_and_onehot(seed, shape=(2, 16, 24), n_classes=3):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((*shape, n_classes)).astype(np.float32)
    targets = rng.integers(0, n_classes, shape).astype(np.int32)
    return logits, targets


@pytest.mark.parametrize("reduce_batch_first", [False, True])
def test_dice_coeff_matches_jax(reduce_batch_first):
    rng = np.random.default_rng(60)
    a = rng.random((3, 8, 9)).astype(np.float32)
    b = (rng.random((3, 8, 9)) > 0.5).astype(np.float32)
    want = JD.dice_coeff(jnp.asarray(a), jnp.asarray(b), reduce_batch_first)
    got = TD.dice_coeff(torch.from_numpy(a), torch.from_numpy(b), reduce_batch_first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multiclass_dice_coeff_matches_jax():
    logits, targets = _probs_and_onehot(61)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    onehot = np.eye(3, dtype=np.float32)[targets]
    want = JD.multiclass_dice_coeff(jnp.asarray(probs), jnp.asarray(onehot))
    got = TD.multiclass_dice_coeff(torch.from_numpy(probs), torch.from_numpy(onehot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", ["empty_empty", "empty_pred", "one_empty_sample"])
def test_dice_sets_sum_zero_quirk(case):
    """Where sets_sum == 0 it is replaced by inter: an empty/empty pair is 1."""
    a = np.zeros((2, 4, 4), np.float32)
    b = np.zeros((2, 4, 4), np.float32)
    if case == "empty_pred":
        b[:, 1:3, 1:3] = 1
    elif case == "one_empty_sample":
        a[0, :2] = 1
        b[0, 1:] = 1
    for fn, args in ((TD.dice_coeff, ()), (TD.dice_loss, ())):
        jfn = getattr(JD, fn.__name__)
        want = jfn(jnp.asarray(a), jnp.asarray(b), *args)
        got = fn(torch.from_numpy(a), torch.from_numpy(b), *args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "empty_empty":
        assert TD.dice_coeff(torch.from_numpy(a), torch.from_numpy(b)).item() == 1.0
        assert TD.dice_loss(torch.from_numpy(a), torch.from_numpy(b)).item() == 0.0


def test_dice_loss_value_and_grad_match_jax():
    logits, targets = _probs_and_onehot(62)
    onehot = np.eye(3, dtype=np.float32)[targets]
    want, want_g = jax.value_and_grad(lambda z: JD.dice_loss(
        jax.nn.softmax(z, -1), jnp.asarray(onehot), multiclass=True))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = TD.dice_loss(torch.softmax(z, -1), torch.from_numpy(onehot), multiclass=True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("shape", [(2, 16, 24), (1, 7, 5)])
def test_compute_loss_multiclass_value_and_grad_match_jax(shape):
    logits, targets = _probs_and_onehot(63, shape)
    cfg_j, cfg_t = JL.LossConfig(n_classes=3), TL.LossConfig(n_classes=3)

    def jax_loss(z):
        loss, metrics = JL.compute_loss(z, jnp.asarray(targets), cfg_j)
        return loss, metrics

    (want, want_m), want_g = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got, got_m = TL.compute_loss(z, torch.from_numpy(targets), cfg_t)
    got.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), **TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), **TOL)


def test_compute_loss_takes_bf16_logits_in_f32():
    logits, targets = _probs_and_onehot(64)
    cfg = TL.LossConfig()
    lo = torch.from_numpy(logits).bfloat16()
    got, _ = TL.compute_loss(lo, torch.from_numpy(targets), cfg)
    want, _ = TL.compute_loss(lo.float(), torch.from_numpy(targets), cfg)
    assert got.dtype == torch.float32 and got.item() == want.item()


def test_cross_entropy_matches_torch_and_jax():
    logits, targets = _probs_and_onehot(65)
    got = TL.cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets))
    want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(targets))
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                            torch.from_numpy(targets).long())
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    np.testing.assert_allclose(got.item(), ref.item(), **TOL)


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(66)
    x = (rng.standard_normal((2, 8, 8)) * 4).astype(np.float32)
    z = (rng.random((2, 8, 8)) > 0.5).astype(np.float32)
    got = TL.bce_with_logits(torch.from_numpy(x), torch.from_numpy(z))
    want = JL.bce_with_logits(jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(got.item(), float(want), **TOL)


@pytest.mark.parametrize("kw", [
    dict(n_classes=3), dict(n_classes=3, multiclass_boundary=True),
    dict(n_classes=1), dict(n_classes=1, connected_component=True),
    dict(n_classes=1, connected_component=True, cc_emit_probs=True),
])
def test_metric_keys_match_jax(kw):
    assert TL.metric_keys(TL.LossConfig(**kw)) == JL.metric_keys(JL.LossConfig(**kw))


def test_loss_config_fields_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(TL.LossConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JL.LossConfig)])


# the values of pred on both sides of the auto-sigmoid's |x| = 10 test
PRED_RANGES = {"probs": (0.0, 1.0), "below_10": (-9.5, 9.5), "above_10": (-2.0, 10.5),
               "below_minus_10": (-10.5, 2.0)}


@pytest.mark.parametrize("edge_width", [5, 64])
@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("kind", sorted(PRED_RANGES))
def test_boundary_loss_matches_jax(kind, channels, edge_width):
    """Probabilities and logits on both sides of |x| = 10, C = 1 (squeezed
    and kept), 2 and 3 (channel 1), a frame narrower than the image and one
    of edge_width >= H, targets in {0, 1, 255}."""
    rng = np.random.default_rng(70 + channels)
    lo, hi = PRED_RANGES[kind]
    shape = (2, 24, 20) if channels == 1 and edge_width == 5 else (2, 24, 20, channels)
    x = rng.uniform(lo, hi, shape).astype(np.float32)
    t = rng.choice([0, 1, 255], (2, 24, 20)).astype(np.float32)
    t[:, 6:16, 4:14] = 255  # a region, so that the target has a boundary
    want = JB.boundary_loss(jnp.asarray(x), jnp.asarray(t), edge_width=edge_width,
                            edge_weight=15.0)
    got = TB.boundary_loss(torch.from_numpy(x), torch.from_numpy(t), edge_width=edge_width,
                           edge_weight=15.0)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_boundary_loss_has_zero_gradient():
    """The term comes from comparisons only: it adds nothing to a gradient,
    in bf16 as in f32, and stays out of the autograd graph."""
    rng = np.random.default_rng(75)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(np.float32) * 20)
    t = torch.from_numpy(rng.choice([0.0, 255.0], (2, 16, 16)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        z = x.to(dtype).requires_grad_()
        bl = TB.boundary_loss(z, t, edge_width=4)
        assert not bl.requires_grad and bl.dtype == torch.float32 and bl.item() > 0
        (g,) = torch.autograd.grad((z.float() ** 2).sum() + bl, z)
        torch.testing.assert_close(g, (2 * z.float()).to(dtype), rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(n_classes=1), dict(n_classes=3, multiclass_boundary=True)])
def test_boundary_branches_match_jax(kw):
    """The binary criterion (targets // 2, BCE + Dice + 0.25 * boundary at edge
    51 / weight 15) and the multiclass boundary term (weight 7): every metric
    and the gradient against JAX's (the boundary term adds none)."""
    rng = np.random.default_rng(67)
    logits = (rng.standard_normal((2, 64, 48, kw["n_classes"])) * 3).astype(np.float32)
    targets = rng.integers(0, 3, (2, 64, 48)).astype(np.int32)
    (want, want_m), want_g = jax.value_and_grad(
        lambda z: JL.compute_loss(z, jnp.asarray(targets), JL.LossConfig(**kw)),
        has_aux=True)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got, got_m = TL.compute_loss(z, torch.from_numpy(targets), TL.LossConfig(**kw))
    got.backward()
    assert set(got_m) == set(want_m) >= {"boundary", "loss"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), **TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), **TOL)


def _blob_probs(seed):
    """(3, 96, 128) probabilities with blobs of every kind the penalty scores:
    small ones, large ones at the border and large ones in the middle."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 0.4, (3, 96, 128)).astype(np.float32)
    p[0, 5:9, 5:12] = 0.9
    p[0, 30:80, 40:100] = 0.8
    p[1, 0:60, 0:40] = 0.7
    p[1, 50:52, 120:127] = 0.95
    p[2] = rng.uniform(0, 1, (96, 128))
    return p


@pytest.mark.parametrize("kw", [dict(), dict(edge_distance=20, min_area=200,
                                             penalty_weight=0.5)])
def test_connected_component_loss_matches_jax(kw):
    p = _blob_probs(76)
    got = TCC.connected_component_loss(p, **kw)
    assert got > 0 and got == JCC.connected_component_loss(p, **kw)


def test_cc_penalty_joins_the_loss_value_only():
    """With connected_component the binary loss hands out its detached
    probabilities for the host penalty, and neither its value nor its
    gradient changes."""
    rng = np.random.default_rng(77)
    logits = (rng.standard_normal((2, 32, 32, 1)) * 3).astype(np.float32)
    targets = torch.from_numpy(rng.integers(0, 3, (2, 32, 32)).astype(np.int32))
    grads, losses = [], []
    for cc in (False, True):
        z = torch.from_numpy(logits).requires_grad_()
        cfg = TL.LossConfig(n_classes=1, connected_component=cc, cc_emit_probs=True)
        loss, m = TL.compute_loss(z, targets, cfg)
        loss.backward()
        grads.append(z.grad)
        losses.append((loss.item(), m))
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    (plain, _), (with_cc, m) = losses
    probs = torch.sigmoid(torch.from_numpy(logits)[..., 0]).numpy()
    assert with_cc == plain and not m["cc_probs"].requires_grad
    np.testing.assert_array_equal(m["cc_probs"].numpy(), probs)
    assert TCC.connected_component_loss(m["cc_probs"].numpy()) > 0


def test_cc_penalty_needs_emitted_probs():
    """The penalty is scored only at train_model's delayed fetch: without
    cc_emit_probs the loss refuses, and names that route."""
    logits = torch.zeros((1, 16, 16, 1))
    targets = torch.zeros((1, 16, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="cc_emit_probs=True"):
        TL.compute_loss(logits, targets, TL.LossConfig(n_classes=1, connected_component=True))


@pytest.mark.parametrize("kw", [
    dict(n_classes=3), dict(n_classes=3, multiclass_boundary=True),
    dict(n_classes=1), dict(n_classes=3, connected_component=True),
    dict(n_classes=1, connected_component=True, cc_emit_probs=True),
])
def test_metric_keys_match_the_real_dict(kw):
    rng = np.random.default_rng(78)
    logits = torch.from_numpy(rng.standard_normal((1, 16, 16, kw["n_classes"]))
                              .astype(np.float32))
    targets = torch.from_numpy(rng.integers(0, 3, (1, 16, 16)).astype(np.int32))
    _, metrics = TL.compute_loss(logits, targets, TL.LossConfig(**kw))
    assert tuple(metrics) == TL.metric_keys(TL.LossConfig(**kw))
