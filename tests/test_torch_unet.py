"""The port's unet_s (full widths 16..256) against the JAX package's, on the
same weights carried by ``state_dict_from_jax``; f32 on the CPU.  The weights
are chip_smoke's seeded numpy pytrees in the JAX layout, with BN affines and
running stats off identity, so every BN term is compared."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.engine import checkpoint as TC
from unet_medical_image_contour_segmentation_torch.models.fold_bn import fold_bn
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import get_model
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s as torch_unet_s
from unet_medical_image_contour_segmentation_tpu.engine import checkpoint as JC
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_s as jax_unet_s
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_sa as jax_unet_sa

TOL = dict(rtol=1e-4, atol=1e-4)


def test_seeded_weights_have_the_jax_structure():
    """The smoke test's seeded numpy weights have exactly the pytree (keys,
    shapes, dtypes) that the JAX model's own init does."""
    want = jax.eval_shape(jax_unet_s(1, 3).init, jax.random.PRNGKey(0))
    got = random_unet_params(0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


@pytest.fixture(scope="module")
def weights():
    return random_unet_params(0)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(1).random((2, 64, 64, 1), dtype=np.float32)


def port_model(params, state):
    model = torch_unet_s()
    model.load_state_dict(state_dict_from_jax(params, state))
    return model.eval()


def port_logits(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("layout", ["nhwc", "auto"])
def test_eval_logits_match_jax(weights, images, layout):
    params, state = weights
    want, _ = jax_unet_s(1, 3, layout=layout).apply(params, state, jnp.asarray(images),
                                                     train=False)
    got = port_logits(port_model(params, state), images)
    assert got.shape == (2, 64, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_train_forward_and_running_stats_match_jax(weights, images):
    params, state = weights
    want, new_state = jax_unet_s(1, 3, layout="nhwc").apply(
        params, state, jnp.asarray(images), train=True)
    model = port_model(params, state).train()
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    # batch statistics: both take the variance one-pass (E[x^2] - E[x]^2),
    # their f32 sums in other orders; the difference grows through 18 BN layers
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-3)
    _, got_state, _ = params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(new_state)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_folded_matches_unfolded(weights, images):
    model = port_model(*weights)
    folded = fold_bn(model)
    np.testing.assert_allclose(port_logits(folded, images), port_logits(model, images),
                               **TOL)


def test_fold_stores_packed_weights_in_compute_dtype(weights):
    folded = fold_bn(port_model(*weights), torch.bfloat16)
    w = folded.inc.w2
    assert w.dtype == torch.bfloat16 and w.shape == (3, 3, 16, 16) and w.is_contiguous()


def test_rank3_input(weights, images):
    model = port_model(*weights)
    np.testing.assert_array_equal(port_logits(model, images[..., 0]),
                                  port_logits(model, images))


def test_state_dict_round_trip(weights, images):
    params, state = weights
    model = port_model(params, state)
    p2, s2, mask_values = params_from_state_dict(model.state_dict())
    assert mask_values is None
    assert jax.tree.structure((params, state)) == jax.tree.structure((p2, s2))
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)
    again = port_model(p2, s2)
    np.testing.assert_array_equal(port_logits(again, images), port_logits(model, images))


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_jax_checkpoint_loads_into_port(weights, images, tmp_path, suffix):
    params, state = weights
    path = str(tmp_path / f"ck{suffix}")
    JC.save_checkpoint(path, params, state, mask_values=[0, 128, 255])
    sd, mask_values = TC.load_weights(path)
    assert mask_values == [0, 128, 255]
    model = torch_unet_s()
    model.load_state_dict(sd)
    np.testing.assert_array_equal(port_logits(model.eval(), images),
                                  port_logits(port_model(params, state), images))


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_port_checkpoint_loads_into_jax(weights, tmp_path, suffix):
    params, state = weights
    path = str(tmp_path / f"ck{suffix}")
    TC.save_checkpoint(path, port_model(params, state), mask_values=[0, 128, 255])
    p2, s2, mask_values = JC.load_weights(path)
    assert mask_values == [0, 128, 255]
    assert jax.tree.structure((params, state)) == jax.tree.structure((p2, s2))
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_presets_and_registry():
    assert get_model("unet_t").widths == (8, 16, 32, 64, 128)
    assert get_model("unet").widths == (64, 128, 256, 512, 1024)
    sa = get_model("unet_sa")
    assert sa.widths == (16, 32, 64, 128, 256) and sa.use_attention and sa.name == "unet_sa"
    assert "up1.attention.conv1.weight" in sa.state_dict()
    bl = torch_unet_s(bilinear=True)
    assert bl.bilinear and "up1.up.weight" not in bl.state_dict()
    with pytest.raises(ValueError, match="unet_pp"):  # the error lists every model
        get_model("unet_ppp")


VARIANTS = {  # name: (port kwargs, JAX model, seeded-weight kwargs)
    "unet_sa": ({}, jax_unet_sa(1, 3), dict(attention=True)),
    "unet_s_bilinear": ({"bilinear": True}, jax_unet_s(1, 3, True), dict(bilinear=True)),
    "unet_sa_bilinear": ({"bilinear": True}, jax_unet_sa(1, 3, True),
                         dict(bilinear=True, attention=True)),
}


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant(request):
    kw, jax_model, wkw = VARIANTS[request.param]
    params, state = random_unet_params(5, **wkw)
    model = get_model("unet_sa" if jax_model.use_attention else "unet_s", **kw)
    model.load_state_dict(state_dict_from_jax(params, state))
    return model.eval(), jax_model, params, state, wkw


def test_variant_weights_have_the_jax_structure(variant):
    _, jax_model, params, state, _ = variant
    want = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0))
    assert jax.tree.structure((params, state)) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves(want)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_variant_eval_matches_jax(variant, hw):
    """unet_sa and bilinear ups: the eval forward and the BN-folded forward
    against the JAX model's, f32 within 1e-4."""
    model, jax_model, params, state, _ = variant
    x = np.random.default_rng(6).random((2, *hw, 1), dtype=np.float32)
    want, _ = jax_model.with_options(layout="nhwc").apply(params, state, jnp.asarray(x),
                                                           train=False)
    np.testing.assert_allclose(port_logits(model, x), np.asarray(want), **TOL)
    np.testing.assert_allclose(port_logits(fold_bn(model), x), np.asarray(want), **TOL)


def test_variant_state_dict_round_trip(variant, tmp_path):
    """The weight carrier maps up{i}/att/conv/w and bilinear ups both ways,
    and a reference .pth with attention keys loads."""
    model, jax_model, params, state, _ = variant
    p2, s2, _ = params_from_state_dict(model.state_dict())
    assert jax.tree.structure((params, state)) == jax.tree.structure((p2, s2))
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((p2, s2))):
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "ref.pth")
    torch.save(dict(model.state_dict(), mask_values=[0, 128, 255]), path)
    sd, mask_values = TC.load_weights(path)
    assert mask_values == [0, 128, 255]
    assert any(k.endswith("attention.conv1.weight") for k in sd) == jax_model.use_attention
    again = get_model(model.name, bilinear=model.bilinear)
    again.load_state_dict(sd)
    x = np.random.default_rng(7).random((1, 32, 32, 1), dtype=np.float32)
    np.testing.assert_array_equal(port_logits(again.eval(), x), port_logits(model, x))
    jp, js, _ = JC.load_weights(path, bilinear=model.bilinear,
                                use_attention=jax_model.use_attention)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves((jp, js))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_fold_leaves_the_attention_conv():
    params, state = random_unet_params(5, attention=True)
    model = get_model("unet_sa")
    model.load_state_dict(state_dict_from_jax(params, state))
    folded = fold_bn(model, torch.bfloat16)
    assert folded.up1.attention.conv1.weight.dtype == torch.float32
    torch.testing.assert_close(folded.up1.attention.conv1.weight,
                               model.up1.attention.conv1.weight)
