"""The port's data parallelism on the CPU: cross-replica BN, the global-batch
losses, the data-parallel train and eval steps, ``train_model(num_devices=2)``
and ranks launched by the caller, and data-parallel serving.

Each multi-process test spawns 2 gloo ranks (``tests/torch_dp_ranks.py``)
with a ``file://`` rendezvous in its own ``tmp_path`` and a timeout of its
own, on weights and batches made from seeds with numpy, and holds them
against the single-device port and against the JAX package's data-parallel
step on a 2-device CPU mesh (``tests/conftest.py`` gives JAX 8 virtual CPU
devices).  The file takes about 60 s on one worker, most of it the ranks'
start-up (about 4 s a spawn).

Tolerances (f32) and why:
* the port's data-parallel step against JAX's: loss, loss terms and grad
  norm to 1e-5 relative, the BN running statistics to 1e-6 absolute (both
  take the variance one-pass, as ``mean_sq - mean**2``, over the group),
  and the averaged, clipped gradients to 1e-5 absolute of JAX's f64
  gradients of the single-device loss on the global batch (GRAD_ATOL of
  ``tests/test_torch_train.py``);
* the parameters after the step, against JAX's and against the port's
  single-device step: all but 0.1% of them to 1e-5, and every one within
  20 * lr.  RMSprop's first step moves each parameter by ~10 * lr * sign(g)
  whatever |g|, so a gradient within f32 rounding of zero (measured: a few
  in 10^4) can move the other way (``tests/test_torch_train.py``);
* against the port's single-device step on the global batch (the same
  one-pass variance, its sums in another order): the loss to 1e-5
  relative, the gradients to 1e-5 of the largest one, the BN statistics to
  1e-6;
* the data-parallel step over a group of one rank against the plain step:
  bit for bit.  Both take the variance one-pass (JAX's formula): in bf16
  it is as good as the two-pass one (``chip_smoke.py``'s A0), so one
  device takes it too, and a group's BN is the plain BN;
* masks of data-parallel serving: exactly equal to single-device serving.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dp_ranks import (
    LR,
    bn_and_losses,
    dp_evaluate,
    np_samples,
    plain_and_group_steps,
    run_ranks,
    train_in_group,
    train_step,
)

from chip_smoke import random_unet_params, rect_batch
from unet_medical_image_contour_segmentation_torch.config import TrainConfig
from unet_medical_image_contour_segmentation_torch.data.loader import DataLoader
from unet_medical_image_contour_segmentation_torch.engine.evaluate import evaluate
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import (
    make_train_step,
    train_model,
)
from unet_medical_image_contour_segmentation_torch.losses import boundary as TB
from unet_medical_image_contour_segmentation_torch.losses import compound as TL
from unet_medical_image_contour_segmentation_torch.losses import dice as TD
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    params_tree_from_tensors,
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s, unet_t
from unet_medical_image_contour_segmentation_torch.ops.nn import batch_norm
from unet_medical_image_contour_segmentation_tpu.engine import optim as JO
from unet_medical_image_contour_segmentation_tpu.engine import train as JT
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_t as jax_unet_t
from unet_medical_image_contour_segmentation_tpu.ops import nn as JN
from unet_medical_image_contour_segmentation_tpu.parallel import (
    batch_sharding,
    make_data_mesh,
    make_parallel_train_step,
    replicate,
)

WIDTHS_T = (8, 16, 32, 64, 128)
RANKS = 2
GRAD_ATOL = 1e-5  # against JAX's gradients computed in f64 (tests/test_torch_train.py)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread per test process (the spawned ranks take one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _halves(results, key):
    return torch.cat([r[key] for r in results])


# -- cross-replica BN and the global-batch losses ----------------------------

@pytest.fixture(scope="module")
def bn_loss_data():
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2, (4, 16, 16, 3)).astype(np.float32)
    logits[3, 5, 5, 1] = 12.0  # only rank 1 sees a logit: the logits test is the group's
    return {
        "x": rng.normal(0.5, 2.0, (4, 8, 8, 6)).astype(np.float32),
        "g": rng.normal(0, 1, (4, 8, 8, 6)).astype(np.float32),
        "scale": rng.uniform(0.8, 1.2, 6).astype(np.float32),
        "bias": rng.normal(0, 0.1, 6).astype(np.float32),
        "rm": rng.normal(0, 0.1, 6).astype(np.float32),
        "rv": rng.uniform(0.8, 1.2, 6).astype(np.float32),
        "logits": logits,
        # rank 0's rows have no class 2: an empty binary target there
        "targets": np.concatenate([rng.integers(0, 2, (2, 16, 16)),
                                   rng.integers(0, 3, (2, 16, 16))]).astype(np.int64),
    }


@pytest.fixture(scope="module")
def bn_loss_results(bn_loss_data, tmp_path_factory):
    return run_ranks(bn_and_losses, (bn_loss_data,), tmp_path_factory.mktemp("bn"))


def test_batch_norm_over_group_matches_concatenated_batch(bn_loss_data, bn_loss_results):
    """2 ranks of (2, 8, 8, 6) against one BN over the (4, 8, 8, 6) batch:
    outputs, running statistics (also against JAX's batch_norm) and the
    gradients of sum(y * g) through the all-reduce."""
    d = bn_loss_data
    x = torch.from_numpy(d["x"]).requires_grad_()
    scale = torch.from_numpy(d["scale"]).requires_grad_()
    bias = torch.from_numpy(d["bias"]).requires_grad_()
    y, (mean, var) = batch_norm(x, scale, bias, torch.from_numpy(d["rm"]),
                                torch.from_numpy(d["rv"]), train=True)
    (y * torch.from_numpy(d["g"])).sum().backward()
    got = bn_loss_results
    torch.testing.assert_close(_halves(got, "y"), y.detach(), rtol=0, atol=1e-5)
    torch.testing.assert_close(_halves(got, "dx"), x.grad, rtol=0, atol=1e-5)
    # the affine parameters' gradients are each rank's share: they sum to the batch's
    torch.testing.assert_close(got[0]["dscale"] + got[1]["dscale"], scale.grad, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got[0]["dbias"] + got[1]["dbias"], bias.grad, rtol=1e-5,
                               atol=1e-5)
    for r in got:
        torch.testing.assert_close(r["mean"], mean, rtol=0, atol=1e-6)
        torch.testing.assert_close(r["var"], var, rtol=0, atol=1e-6)
    _, (jmean, jvar) = JN.batch_norm(jnp.asarray(d["x"]), jnp.asarray(d["scale"]),
                                     jnp.asarray(d["bias"]), jnp.asarray(d["rm"]),
                                     jnp.asarray(d["rv"]), train=True)
    np.testing.assert_allclose(got[0]["mean"].detach().numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got[0]["var"].detach().numpy(), np.asarray(jvar), rtol=0,
                               atol=1e-6)


def _single_losses(d):
    targets = torch.from_numpy(d["targets"])
    return {
        "ce": lambda z: TL.cross_entropy(z, targets),
        "bce": lambda z: TL.bce_with_logits(z[..., 0], targets.float() // 2),
        "dice": lambda z: TD.dice_loss(torch.softmax(z, -1),
                                       torch.nn.functional.one_hot(targets, 3).float(),
                                       multiclass=True),
        "boundary": lambda z: TB.boundary_loss(z, (targets * 127.5).float(), edge_width=4),
        "multiclass": lambda z: TL.compute_loss(z, targets, TL.LossConfig())[0],
        "binary": lambda z: TL.compute_loss(z[..., :1], targets,
                                            TL.LossConfig(n_classes=1))[0],
    }


@pytest.mark.parametrize("name", ["ce", "bce", "dice", "boundary", "multiclass", "binary"])
def test_loss_over_group_matches_global_batch(bn_loss_data, bn_loss_results, name):
    """Each term over 2 ranks equals the term on the global batch (Dice is
    not the mean of the ranks' Dice; the boundary term's logits test sees
    rank 1's logit of 12), and each rank's gradient is 2x its rows' share of
    the global gradient (the all-reduce's backward sums both ranks')."""
    z = torch.from_numpy(bn_loss_data["logits"]).requires_grad_()
    want = _single_losses(bn_loss_data)[name](z)
    if want.requires_grad:
        want.backward()
    for value, _ in (r[name] for r in bn_loss_results):
        assert value == pytest.approx(want.item(), rel=1e-6, abs=1e-7)
    grads = [g for _, g in (r[name] for r in bn_loss_results)]
    if z.grad is None:
        assert grads == [None, None]
        return
    torch.testing.assert_close(torch.cat(grads) / RANKS, z.grad, rtol=1e-5, atol=1e-8)


def test_dice_over_group_is_not_the_mean_of_rank_dice(bn_loss_data, bn_loss_results):
    """The counterexample the global sums exist for: in the binary loss the
    mean of the two halves' Dice losses differs from the group's, which is
    the global batch's.  (The multiclass Dice is no counterexample: every
    pixel's softmax and one-hot sum to 1, so both halves' denominators are
    equal and the mean is the global value.)"""
    d = bn_loss_data
    probs = torch.sigmoid(torch.from_numpy(d["logits"])[..., 0])
    t = torch.from_numpy(d["targets"]).float() // 2
    halves = [TD.dice_loss(probs[s], t[s]).item() for s in (slice(0, 2), slice(2, 4))]
    whole = TD.dice_loss(probs, t).item()
    got = TL.compute_loss(torch.from_numpy(d["logits"])[..., :1], torch.from_numpy(d["targets"]),
                          TL.LossConfig(n_classes=1))[1]["dice"].item()
    assert got == pytest.approx(whole, rel=1e-6)
    assert abs(np.mean(halves) - whole) > 1e-4
    assert bn_loss_results[0]["binary"][0] == pytest.approx(
        _single_losses(d)["binary"](torch.from_numpy(d["logits"])).item(), rel=1e-6)


# -- the data-parallel train step --------------------------------------------

def _jax_state(params, bn_state):
    params = jax.tree.map(jnp.asarray, params)
    return JT.TrainState(params, jax.tree.map(jnp.asarray, bn_state), JO.init_rmsprop(params),
                         jnp.zeros((), jnp.int32))


def _jax_dp_step(n_classes, params, bn_state, batch, cc):
    mesh = make_data_mesh(RANKS)
    cfg = JL.LossConfig(n_classes=n_classes, connected_component=cc, cc_emit_probs=cc)
    step = make_parallel_train_step(jax_unet_t(1, n_classes, layout="nhwc"), cfg,
                                    JO.RMSpropConfig(learning_rate=LR), mesh, donate=False)
    state, metrics = step(replicate(_jax_state(params, bn_state), mesh),
                          jax.device_put(batch, batch_sharding(mesh)), LR)
    return state, metrics


def _port_tree(state):
    params, bn_state, _ = params_from_state_dict(dict(state))
    return params, bn_state


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _jax_f64_grads(n_classes, params, bn_state, batch):
    """JAX's clipped gradients of the single-device loss on the global batch,
    in f64: what the data-parallel step's averaged gradients must equal."""
    model = jax_unet_t(1, n_classes, layout="nhwc")
    cfg = JL.LossConfig(n_classes=n_classes)
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    with jax.enable_x64():
        def loss_fn(p):
            logits, _ = model.apply(p, f64(bn_state), jnp.asarray(batch["image"], jnp.float64),
                                    train=True)
            return JL.compute_loss(logits, jnp.asarray(batch["mask"]), cfg)[0]

        grads, _ = JO.clip_by_global_norm(jax.jit(jax.grad(loss_fn))(f64(params)), 1.0)
        return _leaves(grads)


@pytest.mark.parametrize("n_classes,cc", [(3, False), (1, True)], ids=["multiclass", "binary_cc"])
def test_parallel_train_step_matches_jax_and_single_device(tmp_path, n_classes, cc):
    """unet_t at (4, 64, 64), 2 ranks of 2 rows: against JAX's
    make_parallel_train_step on a 2-device mesh, JAX's f64 gradients of the
    global batch and the port's single-device step on it (see the module
    docstring for the bounds); the two ranks end bit-equal, and each rank's
    cc_probs are its rows of JAX's map."""
    params, bn_state = random_unet_params(0, widths=WIDTHS_T, n_classes=n_classes)
    batch = rect_batch(100, 4, 64, 64)
    got = run_ranks(train_step, ("unet_t", n_classes, params, bn_state, batch, cc), tmp_path)
    for k, v in got[0]["state"].items():
        assert torch.equal(v, got[1]["state"][k]), k
    metrics = got[0]["metrics"]
    model = unet_t(n_classes=n_classes)

    want_state, want = _jax_dp_step(n_classes, params, bn_state, batch, cc)
    for k in ("ce", "dice", "loss") + (("boundary",) if n_classes == 1 else ()):
        assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-5), k
    assert metrics["grad_norm"].item() == pytest.approx(float(want["grad_norm"]), rel=1e-5)
    got_grads = params_tree_from_tensors(model, got[0]["grads"])
    assert max(np.abs(a - b).max() for a, b in zip(
        _leaves(got_grads), _jax_f64_grads(n_classes, params, bn_state, batch))) <= GRAD_ATOL
    got_params, got_bn = _port_tree(got[0]["state"])
    diffs = np.concatenate([np.abs(a - b).ravel() for a, b in zip(
        _leaves(got_params), _leaves(want_state.params))])
    assert diffs.max() <= 20 * LR and (diffs > 1e-5).mean() < 1e-3
    bn_diff = max(np.abs(a - b).max() for a, b in zip(_leaves(got_bn),
                                                        _leaves(want_state.bn_state)))
    assert bn_diff <= 1e-6
    if cc:
        probs = torch.cat([r["metrics"]["cc_probs"] for r in got]).numpy()
        # the sigmoid of logits that the two packages' f32 convs round apart
        # (measured 1.5e-5 at most)
        np.testing.assert_allclose(probs, np.asarray(want["cc_probs"]), rtol=0, atol=5e-5)

    model.load_state_dict(state_dict_from_jax(params, bn_state))
    step = make_train_step(model, TL.LossConfig(n_classes=n_classes, connected_component=cc,
                                                cc_emit_probs=cc),
                           RMSpropConfig(learning_rate=LR))
    single = step({k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    assert metrics["loss"].item() == pytest.approx(single["loss"].item(), rel=1e-5)
    g_max = max(p.grad.abs().max().item() for p in model.parameters())
    g_diff = max((p.grad - got[0]["grads"][k]).abs().max().item()
                 for k, p in model.named_parameters())
    assert g_diff <= 1e-5 * g_max
    diffs = torch.cat([(v.float() - got[0]["state"][k].float()).abs().ravel()
                       for k, v in model.state_dict().items() if "running" in k])
    assert diffs.max().item() <= 1e-6
    diffs = torch.cat([(p.detach() - got[0]["state"][k]).abs().ravel()
                       for k, p in model.named_parameters()])
    assert diffs.max().item() <= 20 * LR and (diffs > 1e-5).float().mean().item() < 1e-3


@pytest.fixture(scope="module")
def world1_run(tmp_path_factory):
    """Both criteria's plain and one-rank-group steps, in one spawned rank."""
    weights = {n: random_unet_params(1, widths=WIDTHS_T, n_classes=n) for n in (3, 1)}
    return run_ranks(plain_and_group_steps, ("unet_t", weights, rect_batch(101, 2, 64, 64)),
                     tmp_path_factory.mktemp("world1"), n=1)[0]


@pytest.mark.parametrize("n_classes", [3, 1], ids=["multiclass", "binary"])
def test_group_of_one_equals_the_plain_step(world1_run, n_classes):
    """The data-parallel step over a gloo group of one rank and the plain
    step, from the same weights on the same (2, 64, 64) batch, end bit for
    bit equal: metrics, gradients, parameters and BN buffers (the BN
    variance is one formula, one-pass, on both paths)."""
    plain, group = world1_run[n_classes, "plain"], world1_run[n_classes, "group"]
    for key in ("metrics", "grads", "state"):
        assert plain[key].keys() == group[key].keys()
        for k, v in plain[key].items():
            assert torch.equal(v, group[key][k]), (key, k)


# -- data-parallel evaluate ---------------------------------------------------

def test_ragged_dp_evaluate_matches_plain(tmp_path):
    """Batch 3 over 8 samples (batches of 3, 3 and 2, padded to 4, 4 and 2)
    sharded over 2 ranks: the Dice triple of every rank equals plain
    evaluate's (JAX tests/test_train_loop.py::test_sharded_evaluate_...)."""
    params, bn_state = random_unet_params(5, widths=WIDTHS_T)
    samples = np_samples(8, 32, seed=7)
    got = run_ranks(dp_evaluate, ("unet_t", params, bn_state, samples, 3), tmp_path)
    model = unet_t()
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    want = evaluate(model, DataLoader(samples, 3, shuffle=False, num_workers=1), device="cpu",
                    postprocess=False)
    assert got[0] == got[1] == want


def test_evaluate_pads_ragged_batches_and_crops_back():
    """One process: batch_pad=4 pads the batches of 3, 3 and 2 by repeating
    their last sample and crops the classes back, so the triple is unchanged."""
    params, bn_state = random_unet_params(5, widths=WIDTHS_T)
    model = unet_t()
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    samples = np_samples(8, 32, seed=7)
    seen = []

    def step(image):
        seen.append(image.shape[0])
        return model(image).argmax(-1).int()

    loader = DataLoader(samples, 3, shuffle=False, num_workers=1)
    want = evaluate(model, loader, device="cpu", postprocess=False)
    assert evaluate(model, loader, device="cpu", postprocess=False, eval_step=step,
                    batch_pad=4) == want
    assert seen == [4, 4, 4]


# -- train_model ---------------------------------------------------------------

def _cfg(tmp_path, **kw):
    # the reference's lr: at 1e-4 RMSprop's sign flips (see above) move two
    # runs' losses apart by ~1e-3 within 4 steps
    base = dict(model="unet_t", epochs=1, batch_size=2, learning_rate=1e-5, amp=False,
                num_workers=1, save_checkpoint=False, save_val_predictions=False,
                val_postprocess=False, progress=False, log_every=0,
                metrics_path=str(tmp_path / "metrics.jsonl"))
    base.update(kw)
    return TrainConfig(**base)


def _run(tmp_path, monkeypatch, cfg):
    """train_model from the same seeded model and samples in ``tmp_path``:
    -> (the returned step, the logged step losses)."""
    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    step = train_model(cfg, model=unet_t(), train_set=np_samples(8, 32, seed=1),
                       val_set=np_samples(4, 32, seed=2), device="cpu")
    with open(cfg.metrics_path) as f:
        losses = [r["loss"] for r in map(json.loads, f) if r["kind"] == "train_step"]
    return step, losses


@pytest.fixture(scope="module")
def spawned_run(tmp_path_factory):
    """train_model(num_devices=2): 8 samples at global batch 2, one epoch,
    on 2 spawned CPU ranks."""
    tmp = tmp_path_factory.mktemp("spawned")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks take the caller's thread count
    try:
        with pytest.MonkeyPatch.context() as mp:
            return _run(tmp, mp, _cfg(tmp, num_devices=2)) + (tmp,)
    finally:
        torch.set_num_threads(threads)


def test_train_model_num_devices_2_takes_4_steps(spawned_run):
    """JAX tests/test_train_loop.py::test_train_model_data_parallel: 4 steps
    of global batch 2 over 8 samples; rank 0 alone logs them and writes the
    final checkpoint, and the returned step holds its state."""
    step, losses, tmp = spawned_run
    assert step.step == 4 and len(losses) == 4 and np.all(np.isfinite(losses))
    assert os.path.exists(tmp / "model_epoch1.npz")
    assert all(p.device.type == "cpu" for p in step.model.parameters())


def test_train_model_two_ranks_match_one_process(spawned_run, tmp_path, monkeypatch):
    """JAX tests/test_multihost.py: two ranks (spawned by train_model) end
    where one process training on the same global batches ends: losses to
    1e-4 relative, the parameters' checksum to 1e-5."""
    step, losses, _ = spawned_run
    single, single_losses = _run(tmp_path, monkeypatch, _cfg(tmp_path))
    np.testing.assert_allclose(losses, single_losses, rtol=1e-4, atol=1e-5)
    checksum = [sum(p.detach().abs().sum().item() for p in s.model.parameters())
                for s in (step, single)]
    assert checksum[0] == pytest.approx(checksum[1], rel=1e-5)


def test_ranks_launched_by_the_caller_match_spawned_ones(spawned_run, tmp_path):
    """parallel.distributed's path (the train CLI's --distributed): two ranks
    that joined a group before train_model end bit-equal to each other and
    to train_model(num_devices=2)'s own ranks."""
    step, _, _ = spawned_run
    cfg = _cfg(tmp_path)
    got = run_ranks(train_in_group, (cfg, np_samples(8, 32, seed=1), np_samples(4, 32, seed=2),
                                     str(tmp_path)), tmp_path)
    for k, v in step.model.state_dict().items():
        assert torch.equal(got[0][k], got[1][k]) and torch.equal(got[0][k], v), k


def test_train_model_checks_the_global_batch(tmp_path):
    with pytest.raises(ValueError, match="batch_size 3 must be divisible by num_devices 2"):
        train_model(_cfg(tmp_path, num_devices=2, batch_size=3), model=unet_t(),
                    train_set=np_samples(4, 32, 0), val_set=np_samples(2, 32, 0), device="cpu")


def test_num_devices_above_the_card_count_raises(tmp_path, monkeypatch):
    """A host with one card: train_model and Predictor refuse two, and fall
    back to nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 CUDA devices"):
        train_model(_cfg(tmp_path, num_devices=2), model=unet_t(),
                    train_set=np_samples(4, 32, 0), val_set=np_samples(2, 32, 0))
    with pytest.raises(ValueError, match="exceeds the 1 CUDA devices"):
        Predictor(unet_t(), num_devices=2)


# -- data-parallel serving ------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    params, bn_state = random_unet_params(3)
    model = unet_s()
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    return model


def _replicas_used(pred):
    used = set()
    logits = pred._logits

    def record(x, r=0):
        used.add(r)
        return logits(x, r)

    pred._logits = record
    return used


@pytest.mark.parametrize("kind", ["dense", "tiled", "int8", "int8_tiled"])
def test_dp_predictor_matches_single_device(served, kind):
    """Predictor(devices=["cpu", "cpu"]) against Predictor(device="cpu"): a
    ragged dense batch of 7 (padded to 8, cropped back), one 128x192 image
    in tiles of 64 (two groups of 4 windows, one on each replica), int8 at
    (8, 64, 64), and int8 tiled; masks exactly equal, both replicas used."""
    rng = np.random.default_rng(9)
    quantize = kind.startswith("int8")
    if kind.endswith("tiled"):
        images = rng.random((1, 128, 192, 1), np.float32)
        kw = dict(tile=64, tile_halo=16, tile_threshold=1)
    else:
        images, kw = rng.random((7 if kind == "dense" else 8, 64, 64, 1), np.float32), {}
    one = Predictor(served, device="cpu", quantize=quantize, **kw)
    two = Predictor(served, devices=["cpu", "cpu"], quantize=quantize, **kw)
    one.tile_batch = two.tile_batch = 4  # 6 tiles: groups of 4 and 2 (+2 duplicates)
    assert two.devices == [torch.device("cpu")] * 2
    used = _replicas_used(two)
    np.testing.assert_array_equal(two.predict_array(images), one.predict_array(images))
    assert used == {0, 1}
    if quantize:
        assert len(two._qreplicas) == 2 and two._amax == one._amax


def test_predictor_num_devices_on_the_cpu(served):
    """num_devices=2 with device="cpu" serves two CPU replicas."""
    assert Predictor(served, device="cpu", num_devices=2).devices == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="does not match"):
        Predictor(served, device="cpu", num_devices=3, devices=["cpu", "cpu"])
