"""The port's Dice and compound loss against the JAX package's, value and
gradient, on the CPU in f32 (rtol 1e-5, atol 1e-6: the same f32 arithmetic
summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.losses import dice as TD
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
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


@pytest.mark.parametrize("kw", [dict(n_classes=1), dict(n_classes=3, multiclass_boundary=True)])
def test_unported_branches_raise(kw):
    logits, targets = _probs_and_onehot(67)
    with pytest.raises(NotImplementedError, match="boundary"):
        TL.compute_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                        TL.LossConfig(**kw))
