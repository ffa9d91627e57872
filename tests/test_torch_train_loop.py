"""The port's train_model loop, train CLI, dataset, loader, metric logger and
config, on the CPU at a tiny size (unet_t, the synthetic 64x64 PNG set of
``tests/test_train_loop.py`` at scale 0.5), against the JAX package where it
has the same component."""

import copy
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from unet_medical_image_contour_segmentation_torch import config as TCFG
from unet_medical_image_contour_segmentation_torch.cli import train as train_cli
from unet_medical_image_contour_segmentation_torch.data.dataset import BasicDataset
from unet_medical_image_contour_segmentation_torch.data.loader import (
    DataLoader,
    prefetch_to_device,
)
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
)
from unet_medical_image_contour_segmentation_torch.engine.train import train_model
from unet_medical_image_contour_segmentation_torch.utils.metrics import MetricLogger
from unet_medical_image_contour_segmentation_tpu import config as JCFG
from unet_medical_image_contour_segmentation_tpu.data import dataset as JD
from unet_medical_image_contour_segmentation_tpu.data import loader as JLD
from unet_medical_image_contour_segmentation_tpu.engine import checkpoint as JC


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel worker processes; one torch
    thread per test keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def data_root(tmp_path):
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        (tmp_path / "imgs" / split).mkdir(parents=True)
        (tmp_path / "masks" / split).mkdir(parents=True)
        for i in range(2):
            img = rng.integers(0, 255, (64, 64), dtype=np.uint8)
            mask = rng.choice([0, 128, 255], (64, 64)).astype(np.uint8)
            Image.fromarray(img).save(tmp_path / "imgs" / split / f"case{i}.png")
            Image.fromarray(mask).save(tmp_path / "masks" / split / f"case{i}_mask.png")
    return tmp_path


def _cfg(data_root, tmp_path, **kw):
    defaults = dict(model="unet_t", data_root=str(data_root), scale=0.5, epochs=2,
                    batch_size=2, learning_rate=1e-4, amp=False, num_workers=2,
                    dir_checkpoint=str(tmp_path / "ckpts"),
                    predictions_dir=str(tmp_path / "preds"), checkpoint_every=1,
                    checkpoint_after_frac=0.4, log_every=0, progress=False)
    defaults.update(kw)
    return TCFG.TrainConfig(**defaults)


class _Arrays:
    """In-memory slices in the BasicDataset protocol."""

    mask_values = [0, 128, 255]

    def __init__(self, n, seed=3, hw=32):
        rng = np.random.default_rng(seed)
        self.images = rng.random((n, hw, hw, 1), dtype=np.float32)
        self.masks = rng.integers(0, 3, (n, hw, hw)).astype(np.int32)

    def __len__(self):
        return len(self.masks)

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i]}


def test_train_model_end_to_end(data_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    result = train_model(_cfg(data_root, tmp_path), device="cpu")
    assert result.step == 2 * ((2 * 4) // 2)  # 2 epochs x (2 images x 4 rotations / b2)
    # checkpoint cadence: epoch > 2 * 0.4 and epoch % 1 == 0 -> epochs 1 and 2
    assert os.path.exists(tmp_path / "ckpts" / "checkpoint_epoch1.npz")
    assert os.path.exists(tmp_path / "ckpts" / "checkpoint_epoch2.npz")
    assert os.path.exists(tmp_path / "model_epoch2.npz")
    preds = os.listdir(tmp_path / "preds" / "epoch_1")
    assert any(p.endswith(".png") for p in preds)
    assert any(p.name.endswith(".png")
               for p in (tmp_path / "preds" / "epoch_1" / "postprocessed").iterdir())
    # the final checkpoint is a full JAX train state
    ck = JC.load_checkpoint(str(tmp_path / "model_epoch2.npz"))
    assert ck["step"] == 8 and ck["mask_values"] == [0, 128, 255, 0, 128, 255]
    assert ck["opt_state"]["square_avg"]["outc"]["w"].shape == (1, 1, 8, 3)
    assert latest_checkpoint(tmp_path / "ckpts").endswith("checkpoint_epoch2.npz")


def test_train_model_resumes_from_a_checkpoint(data_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(data_root, tmp_path, epochs=1, save_val_predictions=False,
               save_checkpoint=False)
    train_model(cfg, device="cpu")
    first = load_checkpoint(str(tmp_path / "model_epoch1.npz"))
    result = train_model(cfg, state=first, device="cpu")
    assert result.step == 8
    second = load_checkpoint(str(tmp_path / "model_epoch1.npz"))
    assert second["step"] == 8
    moved = np.abs(second["params"]["outc"]["w"] - first["params"]["outc"]["w"]).max()
    assert moved > 0


def test_train_model_in_memory_sets_and_metric_log(tmp_path, monkeypatch):
    """In-memory train/val sets, the JSONL metric log and a backend."""
    monkeypatch.chdir(tmp_path)
    seen = []
    cfg = _cfg(tmp_path, tmp_path, epochs=1, save_val_predictions=False, val_postprocess=False,
               save_checkpoint=False, metrics_path=str(tmp_path / "metrics.jsonl"))
    result = train_model(cfg, train_set=_Arrays(6), val_set=_Arrays(4, seed=4), device="cpu",
                         metric_backends=[lambda kind, rec: seen.append(kind)])
    assert result.step == 3
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["kind"] for r in rows] == ["train_step"] * 3 + ["validation"]
    assert set(rows[0]) >= {"step", "ce", "dice", "loss", "grad_norm", "lr"}
    assert seen == [r["kind"] for r in rows]


def test_train_model_batched_nan_check_matches_per_step(data_root, tmp_path, monkeypatch):
    """nan_check_every > 1 fetches the metrics in windows but gives the same
    trajectory and the same per-step log."""
    monkeypatch.chdir(tmp_path)
    params, logs = {}, {}
    for k in (1, 3):
        cfg = _cfg(data_root, tmp_path, nan_check_every=k, epochs=1, save_val_predictions=False,
                   save_checkpoint=False, metrics_path=str(tmp_path / f"metrics_{k}.jsonl"))
        torch.manual_seed(0)
        params[k] = [p.detach().clone() for p in train_model(cfg, device="cpu").model.parameters()]
        with open(tmp_path / f"metrics_{k}.jsonl") as f:
            logs[k] = [(r["step"], r["loss"]) for r in map(json.loads, f)
                       if r["kind"] == "train_step"]
    for a, b in zip(params[1], params[3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert logs[1] == logs[3] and [s for s, _ in logs[1]] == [1, 2, 3, 4]


def test_train_model_nan_aborts(tmp_path, monkeypatch):
    """A NaN loss aborts the loop within nan_check_every + 1 steps (torch's
    RMSprop refuses a NaN lr outright, so the NaN comes from an image)."""
    monkeypatch.chdir(tmp_path)
    train_set = _Arrays(8)
    train_set.images[:] = np.nan
    seen = []
    cfg = _cfg(tmp_path, tmp_path, epochs=1, nan_check_every=2, batch_size=1,
               save_val_predictions=False, save_checkpoint=False)
    with pytest.raises(RuntimeError, match="NaN"):
        train_model(cfg, train_set=train_set, val_set=_Arrays(2), device="cpu",
                    metric_backends=[lambda kind, rec: seen.append(kind)])
    assert seen == []  # the first fetched step already fails


@pytest.mark.parametrize("kw,what", [
    (dict(num_devices=4, spatial_shards=2), "data parallelism"),
    (dict(spatial_shards=2), "spatial parallelism"),
])
def test_train_model_refuses_what_is_not_ported(data_root, tmp_path, monkeypatch, kw, what):
    """Spatial parallelism, once refused here, trains, beside data
    parallelism or alone: the 2 x 2 (data, spatial) layout on 4 CPU ranks
    (JAX tests/test_train_loop.py::test_train_model_dp_spatial), and 2 ranks
    with a band of 16 rows each: 4 steps an
    epoch (2 slices, 4 rotations each, at batch 2), every logged loss
    finite, validation through the spatial eval step, rank 0's
    checkpoints."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(data_root, tmp_path, save_val_predictions=False, val_postprocess=False,
               metrics_path=str(tmp_path / "metrics.jsonl"), **kw)
    step = train_model(cfg, device="cpu")
    with open(cfg.metrics_path) as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if r["kind"] == "train_step"]
    assert step.step == len(losses) == 8 and np.all(np.isfinite(losses)), what
    assert len([r for r in records if r["kind"] == "validation"]) == 2
    assert os.path.exists(tmp_path / "model_epoch2.npz")
    assert os.path.exists(tmp_path / "ckpts" / "checkpoint_epoch2.npz")


def test_train_model_trains_yolo_row_sharded(tmp_path, monkeypatch):
    """A small YOLOv8-seg (binary criterion) on 2 CPU ranks with a band of 64
    rows each (2 at stride 32, the least SPPF's halo allows) logs the losses
    of one process's run to 1e-5 relative, step for step."""
    from unet_medical_image_contour_segmentation_torch.models.yolov8_seg import YOLOv8Seg

    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    model = YOLOv8Seg(n_classes=1, widths=(8, 16, 32, 32, 64), depths=(1, 1, 1, 1))
    losses = {}
    for sp in (1, 2):
        cfg = _cfg(tmp_path, tmp_path, epochs=1, classes=1, learning_rate=1e-5,
                   spatial_shards=sp, save_val_predictions=False, val_postprocess=False,
                   save_checkpoint=False, metrics_path=str(tmp_path / f"metrics{sp}.jsonl"))
        train_model(cfg, model=copy.deepcopy(model), train_set=_Arrays(4, hw=128),
                    val_set=_Arrays(2, seed=4, hw=128), device="cpu")
        with open(cfg.metrics_path) as f:
            losses[sp] = [r["loss"] for r in map(json.loads, f) if r["kind"] == "train_step"]
    assert len(losses[1]) == 2
    np.testing.assert_allclose(losses[2], losses[1], rtol=1e-5, atol=0)


@pytest.mark.parametrize("model", ["unet_pp_m", "yolov8_seg_m"])
def test_train_model_refuses_models_not_ported(data_root, tmp_path, model):
    """Models of neither package (UNet++ and YOLOv8-seg are ported)."""
    with pytest.raises(ValueError, match="unknown model"):
        train_model(_cfg(data_root, tmp_path, model=model), device="cpu")


@pytest.mark.parametrize("kw", [dict(cc_loss=True, classes=1), dict(classes=1),
                                dict(remat=True), dict(bilinear=True), dict(model="unet_sa")])
def test_train_model_trains_the_whole_family(tmp_path, monkeypatch, kw):
    """The binary criterion (with and without the connected-component
    penalty), remat, the bilinear UNet and unet_sa train end to end: every
    step logged finite, the model that was asked for, one checkpoint."""
    monkeypatch.chdir(tmp_path)
    records = []
    cfg = _cfg(tmp_path, tmp_path, epochs=1, save_val_predictions=False, val_postprocess=False,
               save_checkpoint=False, **kw)
    result = train_model(cfg, train_set=_Arrays(4), val_set=_Arrays(2, seed=4), device="cpu",
                         metric_backends=[lambda kind, rec: records.append((kind, rec))])
    steps = [rec for kind, rec in records if kind == "train_step"]
    assert result.step == len(steps) == 2
    assert all(np.isfinite(rec["loss"]) for rec in steps)
    net = result.model
    assert (net.n_classes, net.remat, net.bilinear, net.use_attention) == (
        cfg.classes, cfg.remat, cfg.bilinear, cfg.model == "unet_sa")
    assert ("boundary" in steps[0]) == (cfg.classes == 1)
    assert ("cc" in steps[0]) == cfg.cc_loss
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 2


def test_train_model_logs_the_cc_penalty_on_the_loss(tmp_path, monkeypatch, caplog):
    """classes=1 with cc_loss: each logged loss is the device loss plus the
    host penalty of that step's probabilities, the penalty is logged as
    ``cc``, and a fetch window above 8 steps is clamped to 8."""
    monkeypatch.chdir(tmp_path)
    records = []
    cfg = _cfg(tmp_path, tmp_path, epochs=1, classes=1, cc_loss=True, batch_size=1,
               nan_check_every=20, save_val_predictions=False, val_postprocess=False,
               save_checkpoint=False)
    with caplog.at_level("WARNING"):
        result = train_model(cfg, train_set=_Arrays(10, hw=64), val_set=_Arrays(1, hw=64),
                             device="cpu",
                             metric_backends=[lambda kind, rec: records.append((kind, rec))])
    assert "clamped to 8" in caplog.text
    steps = [rec for kind, rec in records if kind == "train_step"]
    assert [rec["step"] for rec in steps] == list(range(1, 11)) and result.step == 10
    for rec in steps:
        device_loss = rec["ce"] + rec["dice"] + cfg.boundary_weight * rec["boundary"]
        assert rec["loss"] == pytest.approx(device_loss + rec["cc"], rel=1e-6)
        assert rec["cc"] >= 0 and "cc_probs" not in rec
    assert sum(rec["cc"] for rec in steps) > 0


def test_cc_loss_warns_without_the_binary_loss(tmp_path, monkeypatch, caplog):
    monkeypatch.chdir(tmp_path)
    cfg = _cfg(tmp_path, tmp_path, epochs=1, cc_loss=True, save_val_predictions=False,
               val_postprocess=False, save_checkpoint=False)
    with caplog.at_level("WARNING"):
        train_model(cfg, train_set=_Arrays(2), val_set=_Arrays(2), device="cpu")
    assert "no effect with classes=3" in caplog.text


@pytest.mark.parametrize("kw", [dict(sample_cache_bytes=10**8), dict(disk_cache_dir="cache")])
def test_train_model_uses_the_sample_caches(data_root, tmp_path, monkeypatch, kw):
    """The RAM cache and the disk cache (one directory per split, as JAX's)
    train as the uncached run does."""
    monkeypatch.chdir(tmp_path)
    params = []
    for cached in (False, True):
        cfg = _cfg(data_root, tmp_path, epochs=1, save_val_predictions=False,
                   val_postprocess=False, save_checkpoint=False, num_workers=1,
                   **(kw if cached else {}))
        torch.manual_seed(0)
        params.append([p.detach().clone() for p in train_model(cfg, device="cpu")
                       .model.parameters()])
    for a, b in zip(*params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if "disk_cache_dir" in kw:
        for split in ("train", "val"):
            assert len(list((tmp_path / "cache" / split).glob("*.npz"))) == 8


def test_train_model_defaults_to_the_card(data_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_model(_cfg(data_root, tmp_path))


def test_cli_trains_and_resumes(data_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = ["--data-root", str(data_root), "--epochs", "1", "--batch-size", "2", "--model",
            "unet_t", "--scale", "0.5", "--no-amp", "--no-save-val-predictions",
            "--no-val-postprocess", "--device", "cpu"]
    assert train_cli.main(args) == 0
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 4
    assert train_cli.main(args + ["--load", str(tmp_path / "model_epoch1.npz")]) == 0
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 8


def test_cli_loads_reference_pth_weights(data_root, tmp_path, monkeypatch):
    from unet_medical_image_contour_segmentation_torch.models.unet import unet_t

    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    sd = unet_t().state_dict()
    sd["mask_values"] = [0, 128, 255]
    torch.save(sd, tmp_path / "ref.pth")
    assert train_cli.main(["--data-root", str(data_root), "--epochs", "1", "-b", "2",
                           "--model", "unet_t", "--scale", "0.5", "--no-amp",
                           "--no-save-val-predictions", "--no-val-postprocess",
                           "--device", "cpu", "--load", str(tmp_path / "ref.pth")]) == 0
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 4


@pytest.mark.parametrize("flag", ["--num-devices=2", "--spatial-shards=2", "--distributed",
                                  "--coordinator-address=localhost:1234", "--num-processes=2",
                                  "--process-id=1"])
def test_cli_refuses_flags_not_ported(flag):
    """--spatial-shards 2, once refused, parses alone and beside each
    data-parallel and multi-host flag (train_model then keeps JAX's rules:
    tests/test_torch_spatial.py)."""
    args = vars(train_cli.get_args(["--data-root", "d", flag, "--spatial-shards=2"]))
    name, _, value = flag.removeprefix("--").partition("=")
    got = args[name.replace("-", "_")]
    assert args["spatial_shards"] == 2
    assert got == (type(got)(value) if value else True)


@pytest.mark.parametrize("flags,want", [
    (["--bilinear"], dict(bilinear=True)),
    (["--remat"], dict(remat=True)),
    (["--sample-cache-gb=1"], dict(sample_cache_gb=1.0)),
    (["--disk-cache-dir=c"], dict(disk_cache_dir="c")),
    (["--cc-loss"], dict(cc_loss=True)),
    (["--classes=1"], dict(classes=1)),
    (["--model=unet_sa"], dict(model="unet_sa")),
])
def test_cli_takes_the_flags_that_are_ported(flags, want):
    args = vars(train_cli.get_args(["--data-root", "d", *flags]))
    assert {k: args[k] for k in want} == want


def _jax_cli_args(monkeypatch, argv):
    from unet_medical_image_contour_segmentation_tpu.cli import train as jax_train_cli

    monkeypatch.setattr("sys.argv", ["train", *argv])
    return vars(jax_train_cli.get_args())


def test_cli_new_flags_parse_to_the_jax_defaults(monkeypatch):
    ours, theirs = vars(train_cli.get_args([])), _jax_cli_args(monkeypatch, [])
    shared = ("bilinear", "remat", "sample_cache_gb", "disk_cache_dir", "cc_loss", "classes",
              "model", "nan_check_every", "epochs", "batch_size", "lr", "scale", "amp")
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}


class _OutOfMemoryOnce:
    """A train_model stub that runs out of device memory on its first call."""

    def __init__(self, error):
        self.error = error
        self.remat = []

    def __call__(self, cfg, **kw):
        self.remat.append(cfg.remat)
        if len(self.remat) == 1:
            raise self.error


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError("CUDA out of memory"),
                                   RuntimeError("RESOURCE_EXHAUSTED: Out of memory")])
def test_cli_reruns_with_remat_after_out_of_memory(monkeypatch, caplog, error):
    from unet_medical_image_contour_segmentation_torch.engine import train as train_engine

    stub = _OutOfMemoryOnce(error)
    monkeypatch.setattr(train_engine, "train_model", stub)
    with caplog.at_level("ERROR"):
        assert train_cli.main(["--data-root", "d", "--device", "cpu"]) == 0
    assert stub.remat == [False, True]
    assert "Enabling rematerialization" in caplog.text


def test_cli_passes_other_errors_on(monkeypatch):
    from unet_medical_image_contour_segmentation_torch.engine import train as train_engine

    stub = _OutOfMemoryOnce(RuntimeError("a launch failed"))
    monkeypatch.setattr(train_engine, "train_model", stub)
    with pytest.raises(RuntimeError, match="a launch failed"):
        train_cli.main(["--data-root", "d", "--device", "cpu"])
    assert stub.remat == [False]


@pytest.mark.parametrize("variant", [dict(bilinear=True), dict(use_attention=True)])
def test_cli_loads_reference_pth_of_each_variant(data_root, tmp_path, monkeypatch, variant):
    """--load of a reference .pth of a bilinear UNet or a unet_sa trains the
    matching port model from it."""
    from unet_medical_image_contour_segmentation_torch.models.unet import UNet

    monkeypatch.chdir(tmp_path)
    torch.manual_seed(0)
    sd = UNet(widths=(16, 32, 64, 128, 256), **variant).state_dict()
    torch.save(dict(sd, mask_values=[0, 128, 255]), tmp_path / "ref.pth")
    flags = ["--bilinear"] if variant.get("bilinear") else ["--model", "unet_sa"]
    if variant.get("bilinear"):
        flags += ["--model", "unet_s"]
    assert train_cli.main(["--data-root", str(data_root), "--epochs", "1", "-b", "2",
                           "--scale", "0.5", "--no-amp", "--no-save-val-predictions",
                           "--no-val-postprocess", "--sample-cache-gb", "0", "--device", "cpu",
                           "--load", str(tmp_path / "ref.pth"), *flags]) == 0
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 4


def test_cli_defaults_match_jax_cli():
    args = train_cli.get_args([])
    assert (args.epochs, args.batch_size, args.lr, args.scale, args.classes, args.amp,
            args.model, args.device) == (5, 1, 1e-5, 0.5, 3, True, "unet_s", "cuda")


def test_dataset_matches_jax(data_root):
    """Every sample (4 rotations of each image) and the mask values."""
    kw = dict(scale=0.5)
    ours = BasicDataset(data_root / "imgs/train", data_root / "masks/train", **kw)
    theirs = JD.BasicDataset(data_root / "imgs/train", data_root / "masks/train", **kw)
    assert len(ours) == len(theirs) == 8 and ours.mask_values == theirs.mask_values
    assert sorted(ours.ids) == sorted(theirs.ids)
    for i in range(len(ours)):
        a, b = ours[i], theirs[ours.ids.index(theirs.ids[i // 4]) * 4 + i % 4]
        assert a["image"].shape == (32, 32, 1) and a["image"].dtype == np.float32
        assert a["mask"].dtype == np.int32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


@pytest.mark.parametrize("kw", [dict(cache_bytes=10**8), dict(disk_cache_dir="x")])
def test_dataset_caches_give_the_jax_samples(data_root, tmp_path, kw):
    """The RAM cache and the disk cache give JAX's samples, on the first
    pass and from the cache; a disk entry whose source changed is decoded
    and written again."""
    import time

    if "disk_cache_dir" in kw:
        kw = dict(disk_cache_dir=tmp_path / kw["disk_cache_dir"])
    ours = BasicDataset(data_root / "imgs/train", data_root / "masks/train", 0.5, **kw)
    theirs = JD.BasicDataset(data_root / "imgs/train", data_root / "masks/train", 0.5)

    def check():
        for i in range(len(ours)):
            a, b = ours[i], theirs[theirs.ids.index(ours.ids[i // 4]) * 4 + i % 4]
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["mask"], b["mask"])

    check()
    check()  # from the cache
    if "cache_bytes" in kw:
        assert len(ours._cache) == 8 and ours._cache_used <= kw["cache_bytes"]
        return
    entries = sorted(kw["disk_cache_dir"].glob("*.npz"))
    assert len(entries) == 8
    # rewrite one source image: its four entries go stale and are rebuilt
    name = ours.ids[0]
    src = data_root / "imgs/train" / f"{name}.png"
    Image.fromarray(np.full((64, 64), 200, np.uint8)).save(src)
    os.utime(src, (time.time() + 10, time.time() + 10))
    stale = kw["disk_cache_dir"] / f"{name}.r0.s0.5.npz"
    before = stale.stat().st_mtime_ns
    theirs = JD.BasicDataset(data_root / "imgs/train", data_root / "masks/train", 0.5)
    check()
    assert stale.stat().st_mtime_ns != before
    np.testing.assert_array_equal(ours[0]["image"], np.full((32, 32, 1), 200 / 255, np.float32))


def test_dataset_ram_cache_keeps_to_its_budget(data_root):
    one = BasicDataset(data_root / "imgs/train", data_root / "masks/train", 0.5)[0]
    nbytes = one["image"].nbytes + one["mask"].nbytes
    ds = BasicDataset(data_root / "imgs/train", data_root / "masks/train", 0.5,
                      cache_bytes=3 * nbytes)
    for i in range(len(ds)):
        ds[i]
    assert len(ds._cache) == 3 and ds._cache_used == 3 * nbytes


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True), (True, True)])
def test_loader_batches_match_jax(shuffle, drop_last):
    """The same seeded order and batch composition as the JAX DataLoader."""
    rng = np.random.default_rng(5)
    data = [{"image": rng.random((4, 4, 1), dtype=np.float32), "mask": np.full((4, 4), i)}
            for i in range(7)]
    ours = DataLoader(data, 3, shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=9)
    theirs = JLD.DataLoader(data, 3, shuffle=shuffle, drop_last=drop_last, num_workers=2,
                            seed=9)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle advances alike
        for a, b in zip(ours, theirs, strict=True):
            for k in ("image", "mask"):
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_yields_every_batch_in_order():
    batches = [{"image": np.full((2, 3, 3, 1), i, np.float32), "mask": np.full((2, 3, 3), i)}
               for i in range(5)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["mask"][0, 0, 0]) for b in out] == list(range(5))
    assert all(isinstance(b["image"], torch.Tensor) and b["image"].device.type == "cpu"
               for b in out)


@pytest.mark.parametrize("size", [1, 2, 4])
def test_prefetch_batches_equal_their_numpy_batches(size):
    rng = np.random.default_rng(size)
    batches = [{"image": rng.random((2, 8, 8, 1), dtype=np.float32),
                "mask": rng.integers(0, 3, (2, 8, 8)).astype(np.int32)} for _ in range(7)]
    out = list(prefetch_to_device(iter(batches), "cpu", size=size))
    assert len(out) == len(batches)
    for got, want in zip(out, batches):
        for k in want:
            assert got[k].dtype == torch.from_numpy(want[k]).dtype
            np.testing.assert_array_equal(got[k].numpy(), want[k])


@pytest.mark.parametrize("size", [1, 3])
def test_prefetch_runs_at_most_size_batches_ahead(size):
    """While the consumer holds a batch, the thread hands over ``size`` more
    and has pulled one further, which waits for a slot (JAX's queue of
    ``size`` and the batch its thread holds)."""
    import threading
    import time

    pulled = []

    def batches():
        for i in range(50):
            pulled.append(i)
            yield {"mask": np.full((1, 2), i, np.int32)}

    it = prefetch_to_device(batches(), "cpu", size=size)
    assert int(next(it)["mask"][0, 0]) == 0
    deadline = time.monotonic() + 10
    while len(pulled) < size + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    threading.Event().wait(0.3)
    assert len(pulled) == size + 2
    assert [int(b["mask"][0, 0]) for b in it] == list(range(1, 50))


def test_prefetch_refuses_an_empty_queue():
    with pytest.raises(ValueError, match="size must be at least 1"):
        next(prefetch_to_device(iter([]), "cpu", size=0))


def test_prefetch_passes_producer_errors_on():
    def broken():
        yield {"image": np.zeros((1, 2, 2, 1), np.float32)}
        raise OSError("bad slice")

    with pytest.raises(OSError, match="bad slice"):
        list(prefetch_to_device(broken(), "cpu"))


def test_prefetch_stops_its_thread_when_abandoned():
    import threading

    before = threading.active_count()
    batches = ({"mask": np.zeros((1, 2), np.int32)} for _ in range(100))
    it = prefetch_to_device(batches, "cpu", size=1)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_metric_logger_writes_jsonl_and_survives_a_failing_backend(tmp_path):
    seen = []

    def broken(kind, rec):
        raise ValueError("tracker down")

    backends = [broken, lambda kind, rec: seen.append((kind, rec["loss"]))]
    with MetricLogger(str(tmp_path / "m.jsonl"), backends=backends) as mlog:
        mlog.log("train_step", step=1, loss=torch.tensor(0.5), note="x")
    rows = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert rows[0]["loss"] == 0.5 and rows[0]["note"] == "x" and rows[0]["kind"] == "train_step"
    assert seen == [("train_step", 0.5)]


def test_train_config_matches_jax():
    ours = [(f.name, f.default) for f in dataclasses.fields(TCFG.TrainConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JCFG.TrainConfig)]
    assert ours == theirs


def test_config_argparse_helpers():
    import argparse

    parser = TCFG.add_dataclass_args(argparse.ArgumentParser(), TCFG.TrainConfig)
    args = parser.parse_args(["--epochs", "3", "--amp", "false", "--load", "x.npz",
                              "--learning-rate", "0.01"])
    cfg = TCFG.dataclass_from_args(TCFG.TrainConfig, args)
    assert (cfg.epochs, cfg.amp, cfg.load, cfg.learning_rate) == (3, False, "x.npz", 0.01)
