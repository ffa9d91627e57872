"""The port's spatial parallelism on the CPU: the halo exchange, the
row-sharded forward and train steps (1-D and 2-D layouts) against the JAX
package's ``parallel/spatial.py`` on its CPU mesh (``tests/conftest.py``
gives JAX 8 devices), the UNet variants, UNet++ and YOLOv8-seg against
JAX's single-device step, tiled inference, and the rules train_model keeps.

The port's side runs as spawned gloo CPU ranks (``tests/torch_spatial_ranks.py``,
a module without JAX, through ``tests/torch_dp_ranks.py:run_ranks``): one
run of 2 ranks computes every 1-D case, one run of 4 ranks the 2-D layout,
each shared by the tests that read it.  Weights and batches are made from
seeds with numpy and carried into both packages.

Tolerances (f32) and why:
* the forward against JAX's ``make_spatial_forward``: rtol 1e-4, atol 1e-5,
  JAX's own (``tests/test_models_extra.py``);
* a step against JAX's (``make_spatial_train_step``, or its single-device
  step for the variants): the loss terms to 1e-5 relative, parameters to
  rtol 1e-4 / atol 2e-4 and BN statistics to rtol 1e-4 / atol 1e-5, as JAX's
  own spatial tests, at the reference lr of 1e-5 (RMSprop's first step moves
  each parameter by ~10 * lr whatever |g|, so a near-zero gradient that
  rounding flips moves it by 2e-4 at most); the clipped gradients of the
  multiclass steps to 1e-5 absolute of JAX's f64 gradients of the
  single-device loss (GRAD_ATOL of ``tests/test_torch_train.py``) and their
  norm to 1e-5;
* the variants' gradients to 1e-3 of the largest f64 gradient and their
  norm to 1e-4 (the card's D2 bounds in ``chip_smoke.py``): a conv on a band
  of h + 2 rows sums in another order than on the whole images (the CPU's
  convolution library blocks by shape; ~1e-6 relative at 9 * 256 terms,
  where the data-parallel step's convs are the single device's bit for bit),
  and a ReLU input within that of zero then takes the other side, which
  moves a gradient by far more than rounding.  Measured on these seeds:
  1.1e-4 (binary), 9e-5 (remat) and 5.5e-4 (unet_sa, whose single-device
  step is as far from JAX's f64 gradients) of the largest;
* the halo exchange exactly; the sharded convs, upsample and pool against
  the whole images' to 1e-5 (sums in another order; the pool's gradient
  adds a seam row's contributions in another order).

YOLOv8-seg's row-sharded step is held against JAX's single-device step,
not against JAX's ``make_spatial_train_step``: on the CPU mesh (jax 0.9.0)
GSPMD's gradient of SPPF's ``reduce_window`` max pool under H-sharding is
wrong (a 2-device mesh gave a grad norm of 0.7373 where one device and a
4-device mesh gave 0.8508 for this model at 2 x 128², deep gradients off
by up to 1.36x their leaf's largest entry; the pool alone off by 0.52-1.0
of its largest gradient wherever a band holds more than 2 rows), while
its sharded forward is exact.  GSPMD is meant to reproduce the
single-device step, so that is the reference; do not "fix" this test by
comparing with JAX's spatial step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_dp_ranks import run_ranks
from torch_spatial_ranks import (
    LR,
    POOL_SHIFT,
    SP,
    build,
    check_halo,
    halo_data,
    spatial_cases,
)

from chip_smoke import random_params_like, random_unet_params, rect_batch
from unet_medical_image_contour_segmentation_torch.config import TrainConfig
from unet_medical_image_contour_segmentation_torch.engine.train import train_model
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    params_from_state_dict,
    params_tree_from_tensors,
)
from unet_medical_image_contour_segmentation_torch.models.unet import UNet, get_model, unet_t
from unet_medical_image_contour_segmentation_torch.models.unet_nested import UNetPlusPlus
from unet_medical_image_contour_segmentation_torch.models.yolov8_seg import YOLOv8Seg
from unet_medical_image_contour_segmentation_torch.ops.halo import Shard
from unet_medical_image_contour_segmentation_torch.parallel import tiled_inference
from unet_medical_image_contour_segmentation_tpu.engine import optim as JO
from unet_medical_image_contour_segmentation_tpu.engine import train as JT
from unet_medical_image_contour_segmentation_tpu.losses import compound as JL
from unet_medical_image_contour_segmentation_tpu.models.unet import UNet as JaxUNet
from unet_medical_image_contour_segmentation_tpu.models.unet_nested import (
    UNetPlusPlus as JaxUNetPlusPlus,
)
from unet_medical_image_contour_segmentation_tpu.models.yolov8_seg import (
    YOLOv8Seg as JaxYOLOv8Seg,
)
from unet_medical_image_contour_segmentation_tpu.parallel import spatial as JS

WIDTHS_T = (8, 16, 32, 64, 128)
PP_WIDTHS = (8, 16, 32, 64)
# the smallest YOLOv8-seg whose bands of 128² images hold SPPF's 2-row halo
YOLO_KW = dict(n_classes=1, widths=(8, 16, 32, 32, 64), depths=(1, 1, 1, 1))
GRAD_ATOL = 1e-5
# the variants' gradients against JAX's f64 ones: of the largest, and the norm
# (chip_smoke.py's D2_TOL); see the module docstring
VARIANT_GRADS, VARIANT_NORM = 1e-3, 1e-4
# name: (port kwargs, JAX kwargs, random_unet_params kwargs, loss kwargs); the
# binary criterion with its connected-component penalty in the step
VARIANTS = {
    "bilinear": (dict(bilinear=True), dict(bilinear=True), dict(bilinear=True), {}),
    "unet_sa": (dict(use_attention=True), dict(use_attention=True), dict(attention=True), {}),
    "binary": (dict(n_classes=1), dict(n_classes=1), dict(n_classes=1),
               dict(n_classes=1, connected_component=True)),
    "remat": (dict(remat=True), dict(remat=True), {}, {}),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unet_spec(seed=0, kw=None, wkw=None, loss=None, batch=None, image=None):
    params, bn_state = random_unet_params(seed, widths=WIDTHS_T, **(wkw or {}))
    spec = dict(arch="unet", kw=dict(widths=WIDTHS_T, name="unet_t", **(kw or {})),
                params=params, bn_state=bn_state, loss=loss or {})
    if batch is not None:
        spec["batch"] = batch
    if image is not None:
        spec["image"] = image
    return spec


def _pp_spec():
    model = UNetPlusPlus(n_classes=3, widths=PP_WIDTHS)
    params, bn_state = random_params_like(model, 3)
    return dict(arch="unet_pp", kw=dict(n_classes=3, widths=PP_WIDTHS), params=params,
                bn_state=bn_state, batch=rect_batch(102, 2, 64, 64), loss={})


def _yolo_spec(seed, **data):
    params, bn_state = random_params_like(YOLOv8Seg(**YOLO_KW), seed)
    return dict(arch="yolo", kw=YOLO_KW, params=params, bn_state=bn_state,
                loss=dict(n_classes=1, connected_component=True), **data)


@pytest.fixture(scope="module")
def cases():
    out = {
        "forward": ("forward", _unet_spec(seed=1, image=np.random.default_rng(2).random(
            (2, 64, 64, 1), dtype=np.float32))),
        "multiclass": ("step", _unet_spec(batch=rect_batch(100, 2, 64, 64))),
        "unet_pp": ("step", _pp_spec()),
        "halo": ("halo", halo_data()),
        "yolo_forward": ("forward", _yolo_spec(5, image=np.random.default_rng(6).random(
            (2, 128, 128, 1), dtype=np.float32))),
        "yolo": ("step", _yolo_spec(7, batch=rect_batch(104, 2, 128, 128))),
    }
    for name, (kw, _, wkw, loss) in VARIANTS.items():
        out[name] = ("step", _unet_spec(seed=4, kw=kw, wkw=wkw, loss=loss,
                                        batch=rect_batch(101, 2, 64, 64)))
    return out


@pytest.fixture(scope="module")
def spatial_run(cases, tmp_path_factory):
    """Every 1-D case on 2 spawned ranks (one band of 32 rows each, 64 for
    YOLOv8-seg)."""
    return run_ranks(spatial_cases, (1, SP, cases), tmp_path_factory.mktemp("spatial"), n=SP)


@pytest.fixture(scope="module")
def grid_case():
    return _unet_spec(seed=2, batch=rect_batch(103, 2, 64, 64))


@pytest.fixture(scope="module")
def grid_run(grid_case, tmp_path_factory):
    """The multiclass step on the 2 x 2 (data, spatial) layout, 4 ranks."""
    return run_ranks(spatial_cases, (2, 2, {"grid": ("step", grid_case)}),
                     tmp_path_factory.mktemp("grid"), n=4)


def _leaves(tree):
    return [np.asarray(x, np.float64) for x in jax.tree.leaves(tree)]


def _jax_state(params, bn_state):
    params = jax.tree.map(jnp.asarray, params)
    return JT.TrainState(params, jax.tree.map(jnp.asarray, bn_state), JO.init_rmsprop(params),
                         jnp.zeros((), jnp.int32))


def _jax_model(spec, jkw=None):
    if spec["arch"] == "unet_pp":
        return JaxUNetPlusPlus(n_classes=3, widths=PP_WIDTHS, layout="nhwc", name="unet_pp")
    if spec["arch"] == "yolo":
        return JaxYOLOv8Seg(layout="nhwc", **YOLO_KW)
    return JaxUNet(widths=WIDTHS_T, layout="nhwc", name="unet_t", **(jkw or {}))


def _jax_f64_grads(model, spec, loss_cfg):
    """JAX's clipped gradients of the single-device loss on the global batch
    and their global norm, in f64."""
    f64 = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
    batch = spec["batch"]
    with jax.enable_x64():
        def loss_fn(p):
            logits, _ = model.apply(p, f64(spec["bn_state"]),
                                    jnp.asarray(batch["image"], jnp.float64), train=True)
            return JL.compute_loss(logits, jnp.asarray(batch["mask"]), loss_cfg)[0]

        grads, norm = JO.clip_by_global_norm(jax.jit(jax.grad(loss_fn))(f64(spec["params"])),
                                             1.0)
        return _leaves(grads), float(norm)


def _check_step(results, spec, want_state, want, f64_grads, grad_atol=GRAD_ATOL,
                norm_rel=1e-5):
    """The ranks' step against JAX's, and its gradients and their norm
    against JAX's f64 ones (see the module docstring)."""
    got = results[0]
    for r in results[1:]:
        for k, v in got["state"].items():
            assert torch.equal(v, r["state"][k]), k
    metrics = got["metrics"]
    assert set(metrics) == set(want)
    for k in set(want) - {"lr", "grad_norm"}:
        assert metrics[k].item() == pytest.approx(float(want[k]), rel=1e-5), k
    want_grads, want_norm = f64_grads
    got_grads = params_tree_from_tensors(build(spec), got["grads"])
    assert metrics["grad_norm"].item() == pytest.approx(want_norm, rel=norm_rel)
    assert max(np.abs(a - b).max() for a, b in zip(_leaves(got_grads), want_grads)) <= grad_atol
    got_params, got_bn, _ = params_from_state_dict(dict(got["state"]))
    for a, b in zip(_leaves(got_params), _leaves(want_state.params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4)
    for a, b in zip(_leaves(got_bn), _leaves(want_state.bn_state)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# -- the forward and the steps against JAX's ---------------------------------

def _check_forward(cases, spatial_run, name):
    """Every rank's gathered logits of case ``name`` against JAX's
    make_spatial_forward(make_spatial_mesh(2)) and against the port's
    unsharded forward."""
    spec = cases[name][1]
    image = spec["image"]
    fwd = JS.make_spatial_forward(_jax_model(spec), JS.make_spatial_mesh(SP))
    want = np.asarray(fwd(jax.tree.map(jnp.asarray, spec["params"]),
                          jax.tree.map(jnp.asarray, spec["bn_state"]), jnp.asarray(image)))
    for logits in spatial_run:
        assert logits[name].shape == (*image.shape[:3], spec["kw"].get("n_classes", 3))
        np.testing.assert_allclose(logits[name].numpy(), want, rtol=1e-4, atol=1e-5)
    with torch.no_grad():
        plain = build(spec).eval()(torch.from_numpy(image))
    torch.testing.assert_close(spatial_run[0][name], plain, rtol=1e-5, atol=1e-5)


def test_spatial_forward_matches_jax(cases, spatial_run):
    """unet_t at (2, 64, 64) over 2 bands (see _check_forward)."""
    _check_forward(cases, spatial_run, "forward")


def test_spatial_yolo_forward_matches_jax(cases, spatial_run):
    """A small YOLOv8-seg at (2, 128, 128) over 2 bands: its stride-2 convs
    and -inf-filled SPPF pools on bands (see _check_forward)."""
    _check_forward(cases, spatial_run, "yolo_forward")


def test_spatial_train_step_matches_jax(cases, spatial_run):
    """The multiclass unet_t step (ConvT ups, CE + Dice) at (2, 64, 64) over
    2 bands against JAX's make_spatial_train_step on a 2-device mesh, and
    its clipped gradients against JAX's f64 gradients."""
    spec = cases["multiclass"][1]
    model, loss_cfg = _jax_model(spec), JL.LossConfig()
    step = JS.make_spatial_train_step(model, loss_cfg, JO.RMSpropConfig(learning_rate=LR),
                                      JS.make_spatial_mesh(SP))
    want_state, want = step(_jax_state(spec["params"], spec["bn_state"]), spec["batch"], LR)
    _check_step([r["multiclass"] for r in spatial_run], spec, want_state, want,
                _jax_f64_grads(model, spec, loss_cfg))


def test_dp_spatial_step_matches_jax(grid_case, grid_run):
    """The 2 x 2 (data, spatial) layout: 4 ranks, one image and one band
    each, against JAX's step on make_dp_spatial_mesh(2, 2) and JAX's f64
    gradients; the four ranks end bit-equal."""
    model, loss_cfg = _jax_model(grid_case), JL.LossConfig()
    step = JS.make_spatial_train_step(model, loss_cfg, JO.RMSpropConfig(learning_rate=LR),
                                      JS.make_dp_spatial_mesh(2, 2))
    want_state, want = step(_jax_state(grid_case["params"], grid_case["bn_state"]),
                            grid_case["batch"], LR)
    results = [r["grid"] for r in grid_run]
    _check_step(results, grid_case, want_state, want,
                _jax_f64_grads(model, grid_case, loss_cfg))


@pytest.mark.parametrize("name", sorted(VARIANTS) + ["unet_pp", "yolo"])
def test_spatial_variant_step_matches_jax(cases, spatial_run, name):
    """bilinear (the band's rows of the align-corners upsample), unet_sa (a
    3-row halo for the 7x7 gate), binary (the boundary term and the in-step
    cc penalty on gathered whole images), remat (the recompute exchanges its
    halos again), a 4-depth UNet++ and a small YOLOv8-seg with the binary
    criterion and the cc penalty (stride-2 convs, SPPF's pools; see the
    module docstring for why JAX's single-device step) over 2 bands, against
    JAX's single-device step on the whole batch and its f64 gradients."""
    spec = cases[name][1]
    jkw, lkw = VARIANTS[name][1] if name in VARIANTS else {}, spec["loss"]
    model, loss_cfg = _jax_model(spec, jkw), JL.LossConfig(**lkw)
    step = jax.jit(JT.make_train_step(model, loss_cfg, JO.RMSpropConfig(learning_rate=LR)))
    want_state, want = step(_jax_state(spec["params"], spec["bn_state"]), spec["batch"], LR)
    results = [r[name] for r in spatial_run]
    # the f64 gradients of the loss without the penalty: it carries none
    f64_cfg = JL.LossConfig(**{k: v for k, v in lkw.items() if k != "connected_component"})
    grads, norm = _jax_f64_grads(model, spec, f64_cfg)
    g_max = max(np.abs(g).max() for g in grads)
    _check_step(results, spec, want_state, want, (grads, norm), grad_atol=VARIANT_GRADS * g_max,
                norm_rel=VARIANT_NORM)
    if name in ("binary", "yolo"):
        assert {"boundary", "cc"} <= set(results[0]["metrics"])


# -- the halo exchange and the sharded ops -----------------------------------

@pytest.mark.parametrize("name", ["halo1", "halo3", "conv3", "conv7", "upsample", "conv_s2",
                                  "maxpool5"])
def test_halo_ops_match_the_whole_image(cases, spatial_run, name):
    """Each rank's band through the halo exchange (1 and 3 rows: zero rows
    beyond the image, the neighbour's rows at the seam), a 3x3 conv routed
    to the kernel, the 7x7 gate conv, the bilinear upsample, a 3x3 stride-2
    conv (band rows 8 -> 4 outputs, one halo row above) and the 5x5 SPPF
    pool (-inf beyond the image, on an input negative at the image's first
    and last rows, where a zero fill would win) equals its rows of the
    unsharded op; the input gradients, the halo rows' gradients returned to
    their owners included, equal the unsharded gradient's rows; the weight
    gradients sum to the unsharded one."""
    data = cases["halo"][1]
    if name == "maxpool5":
        x = data["x"] - POOL_SHIFT
        assert (x[:, :2] < 0).all() and (x[:, -2:] < 0).all()
    check_halo(spatial_run, name, data)


def test_tiled_inference_matches_jax():
    """parallel.tiled_inference (the Predictor's device grid) against JAX's
    tiled_inference on a 192x192 smooth image in tiles of 64 with a halo of
    48 (JAX's test): the class maps agree (ties aside)."""
    params, bn_state = random_unet_params(7, widths=WIDTHS_T)
    model = build(dict(arch="unet", kw=dict(widths=WIDTHS_T, name="unet_t"), params=params,
                       bn_state=bn_state))
    base = np.random.default_rng(2).random((1, 24, 24, 1), np.float32)
    image = np.kron(base, np.ones((1, 8, 8, 1), np.float32))
    got = tiled_inference(model, torch.from_numpy(image), tile=64, halo=48, tile_batch=4)
    want = np.asarray(JS.tiled_inference(_jax_model({"arch": "unet"}),
                                         jax.tree.map(jnp.asarray, params),
                                         jax.tree.map(jnp.asarray, bn_state),
                                         jnp.asarray(image), tile=64, halo=48))
    assert got.shape == want.shape == (1, 192, 192) and got.dtype == torch.int32
    assert (got.numpy() == want).mean() >= 0.999


# -- the rules -----------------------------------------------------------------

def _cfg(**kw):
    base = dict(model="unet_t", epochs=1, batch_size=2, amp=False, num_workers=1,
                save_checkpoint=False, save_val_predictions=False, val_postprocess=False,
                progress=False)
    base.update(kw)
    return TrainConfig(**base)


@pytest.mark.parametrize("kw,err,match", [
    (dict(num_devices=2, spatial_shards=4), ValueError,
     "spatial_shards 4 exceeds the 2 available devices"),
    (dict(num_devices=6, spatial_shards=4), ValueError,
     "num_devices 6 must be divisible by spatial_shards 4"),
    (dict(num_devices=4, spatial_shards=2, batch_size=3), ValueError,
     r"batch_size 3 must be divisible by the data-parallel degree 2 \(= "
     r"num_devices/spatial_shards\)"),
], ids=["too_many_shards", "indivisible_devices", "indivisible_batch"])
def test_train_model_keeps_jax_rules(kw, err, match):
    """JAX engine/train.py's checks and texts, raised before any rank starts."""
    with pytest.raises(err, match=match):
        train_model(_cfg(**kw), train_set=[], val_set=[], device="cpu")


def test_spatial_training_is_single_host_only(monkeypatch):
    """In a process that is one rank of several (the CLI's --distributed),
    spatial_shards > 1 raises JAX's NotImplementedError."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(NotImplementedError, match="spatial_shards > 1 is single-host only; "
                                                  "use data parallelism across hosts"):
        train_model(_cfg(spatial_shards=2), model=unet_t(), train_set=[], val_set=[],
                    device="cpu")


@pytest.mark.parametrize("arch", ["unet_t", "unet_pp_s", "yolov8_seg_s"])
def test_band_heights_must_fit_the_pools(arch):
    """A band whose height is not a multiple of hw_divisor (H not divisible
    by spatial_shards * hw_divisor) raises before any collective."""
    model = get_model(arch).train()
    shard = Shard(group=None, index=0, size=2)
    with pytest.raises(ValueError, match="H divisible by spatial_shards \\* hw_divisor"):
        model(torch.zeros(1, 24, 32, 1), shard=shard)
    assert isinstance(model, (UNet, UNetPlusPlus, YOLOv8Seg))


def test_yolo_bands_must_hold_the_pools_halo():
    """YOLOv8-seg's bands must hold 2 rows at stride 32, where SPPF's pools
    read 2 rows of each neighbour (H >= spatial_shards * 64; JAX's GSPMD
    also takes bands of 1 row): a band of 32 rows, 1 at stride 32, raises
    before any collective (the shard has no process group)."""
    model = get_model("yolov8_seg_s").train()
    shard = Shard(group=None, index=0, size=2)
    with pytest.raises(ValueError, match=r"needs bands of at least 2 rows at stride 32 \(SPPF's "
                                         r"5x5 pools read 2 rows of each neighbour\): H must be "
                                         r"at least spatial_shards \* 64 = 128; H 64 is not"):
        model(torch.zeros(1, 32, 64, 1), shard=shard)
