"""The port's optimizer, clip and LR schedule against the JAX package's
``engine/optim.py``, and the optimizer state carried between the two
layouts, on the CPU in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.engine import optim as TO
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_tree_from_tensors,
    state_dict_from_jax,
    tensors_from_params_tree,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_t
from unet_medical_image_contour_segmentation_tpu.engine import optim as JO

WIDTHS_T = (8, 16, 32, 64, 128)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_rmsprop_matches_jax_over_steps():
    """The reference hyperparameters, 10 steps of the same gradients: torch's
    RMSprop is JAX's rmsprop_update term for term (f32 rounding apart)."""
    w0, b0 = _rand(4, 3, seed=1), _rand(3, seed=2)
    wt = torch.from_numpy(w0.copy()).requires_grad_()
    bt = torch.from_numpy(b0.copy()).requires_grad_()
    opt = TO.make_optimizer([wt, bt], TO.RMSpropConfig())
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    opt_state = JO.init_rmsprop(params)
    for step in range(10):
        lr = 1e-5 * (1 + step)
        gw, gb = _rand(4, 3, seed=10 + step), _rand(3, seed=30 + step)
        wt.grad, bt.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        params, opt_state = JO.rmsprop_update(
            params, {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}, opt_state,
            JO.RMSpropConfig(), lr)
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(params["w"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(bt.detach().numpy(), np.asarray(params["b"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(opt.state[wt]["square_avg"].numpy(),
                               np.asarray(opt_state["square_avg"]["w"]), rtol=1e-6)
    np.testing.assert_allclose(opt.state[wt]["momentum_buffer"].numpy(),
                               np.asarray(opt_state["momentum_buf"]["w"]), rtol=1e-5)


def test_rmsprop_config_matches_jax():
    assert dataclasses.asdict(TO.RMSpropConfig()) == dataclasses.asdict(JO.RMSpropConfig())


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_matches_jax(scale):
    """Above the max norm the grads scale down; below it they stay."""
    g = {"a": _rand(5, 5, seed=3) * scale, "b": _rand(7, seed=4) * scale}
    clipped, total = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    grads = [torch.from_numpy(g["a"].copy()), torch.from_numpy(g["b"].copy())]
    got_total = TO.clip_by_global_norm(grads, 1.0)
    assert got_total.dtype == torch.float32
    np.testing.assert_allclose(got_total.item(), float(total), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(clipped["a"]), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(clipped["b"]), rtol=1e-6,
                               atol=1e-8)


def test_clip_matches_torch_clip_grad_norm():
    a, b = torch.from_numpy(_rand(6, 4, seed=5) * 3), torch.from_numpy(_rand(9, seed=6))
    pa, pb = torch.zeros_like(a, requires_grad=True), torch.zeros_like(b, requires_grad=True)
    pa.grad, pb.grad = a.clone(), b.clone()
    want = torch.nn.utils.clip_grad_norm_([pa, pb], 1.0)
    grads = [a.clone(), b.clone()]
    got = TO.clip_by_global_norm(grads, 1.0)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(grads[0], pa.grad)
    torch.testing.assert_close(grads[1], pb.grad)


@pytest.mark.parametrize("t", [0.0, 0.5, 0.93, 1.0, 3.9, 4.0, 5.5, 11.0, 12.0, 27.3, 28.0, 60.0])
def test_warm_restarts_matches_jax_and_torch(t):
    want = float(JO.warm_restarts_lr(t, 1e-5, T_0=4, T_mult=2, eta_min=1e-7))
    got = TO.warm_restarts_lr(t, 1e-5, T_0=4, T_mult=2, eta_min=1e-7)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-5)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.RMSprop([p], lr=1e-5)
    sched = torch.optim.lr_scheduler.CosineAnnealingWarmRestarts(opt, T_0=4, T_mult=2,
                                                                 eta_min=1e-7)
    sched.step(t)
    assert got == pytest.approx(opt.param_groups[0]["lr"], rel=1e-9)


@pytest.mark.parametrize("t", [0.0, 2.5, 4.0, 9.75])
def test_warm_restarts_t_mult_1_matches_jax(t):
    want = float(JO.warm_restarts_lr(t, 1e-4, T_0=4, T_mult=1, eta_min=1e-7))
    assert TO.warm_restarts_lr(t, 1e-4, T_0=4, T_mult=1, eta_min=1e-7) == pytest.approx(
        want, rel=1e-5)


@pytest.mark.parametrize("dice", [0.0, 0.31, 0.62, 0.9, 0.999])
def test_warm_restarts_quirk_mode_dice_argument(dice):
    """The reference steps the schedule with the Dice score: t in [0, 1)
    keeps the lr in the top of the first cosine, as JAX's closed form."""
    got = TO.warm_restarts_lr(dice, 1e-5)
    assert 0.5e-5 < got <= 1e-5
    assert got == pytest.approx(float(JO.warm_restarts_lr(dice, 1e-5)), rel=1e-6)


@pytest.fixture(scope="module")
def model_t():
    params, state = random_unet_params(0, widths=WIDTHS_T)
    model = unet_t()
    model.load_state_dict(state_dict_from_jax(params, state))
    return model, params


def test_params_tree_round_trip(model_t):
    """Per-parameter tensors cross to the JAX layout and back unchanged."""
    model, params = model_t
    tensors = {n: p.detach().clone() for n, p in model.named_parameters()}
    tree = params_tree_from_tensors(model, tensors)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    back = tensors_from_params_tree(model, tree)
    for n, t in tensors.items():
        torch.testing.assert_close(back[n], t, rtol=0, atol=0)


def test_opt_state_round_trip(model_t):
    """RMSprop state -> JAX layout -> a fresh optimizer: the same tensors,
    and zeros for a model never stepped."""
    model, params = model_t
    opt = TO.make_optimizer(model.parameters(), TO.RMSpropConfig())
    zero = TO.opt_state_to_jax(model, opt)
    assert all(not np.any(leaf) for leaf in jax.tree.leaves(zero))
    assert jax.tree.structure(zero) == jax.tree.structure(JO.init_rmsprop(params))
    rng = np.random.default_rng(7)
    jax_state = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32),
                             JO.init_rmsprop(params))
    TO.load_opt_state(model, opt, jax_state, step=5)
    again = TO.opt_state_to_jax(model, opt)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jax_state)):
        np.testing.assert_array_equal(a, b)
    p0 = next(model.parameters())
    assert opt.state[p0]["step"].item() == 5
