"""The port's ``utils/`` (version report, memory stats, the profiler
trace, FLOP counts, the mask plot) against the JAX package's, and
the train and predict CLIs' data-parallel, multi-host and ``--viz`` flags.

About 25 s on one worker: the two multi-process CLI runs (2 spawned CPU
ranks each) take most of it.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_dp_ranks import run_ranks, train_cli_rank

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.cli import predict as predict_cli
from unet_medical_image_contour_segmentation_torch.cli import train as train_cli
from unet_medical_image_contour_segmentation_torch.engine.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from unet_medical_image_contour_segmentation_torch.engine.predict import (
    Predictor,
    collect_image_files,
)
from unet_medical_image_contour_segmentation_torch.models.torch_compat import state_dict_from_jax
from unet_medical_image_contour_segmentation_torch.models.unet import get_model, unet_s
from unet_medical_image_contour_segmentation_torch.utils import flops as TF
from unet_medical_image_contour_segmentation_torch.utils import profiling, version_info, viz
from unet_medical_image_contour_segmentation_tpu.cli import predict as jax_predict_cli
from unet_medical_image_contour_segmentation_tpu.cli import train as jax_train_cli
from unet_medical_image_contour_segmentation_tpu.models.unet import get_model as jax_get_model
from unet_medical_image_contour_segmentation_tpu.utils import flops as JF


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_version_info_keys():
    info = version_info.version_info()
    assert set(info) == {"framework", "torch", "cuda", "cudnn", "devices", "numpy"}
    assert info["torch"] == torch.__version__ and info["devices"]
    if not torch.cuda.is_available():
        assert info["devices"] == ["cpu"] and info["cudnn"] is None


def test_device_memory_stats_and_trace(tmp_path):
    """No card: no memory stats; the profiler trace writes a Chrome trace."""
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
    with profiling.trace(str(tmp_path), enabled=False) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof is not None and any(p.endswith(".json") for p in os.listdir(tmp_path))


@pytest.mark.parametrize("name", ["unet", "unet_t", "unet_s", "unet_sa"])
@pytest.mark.parametrize("bilinear", [False, True])
def test_unet_forward_flops_matches_jax(name, bilinear):
    for hw in ((64, 64), (96, 160)):
        assert TF.unet_forward_flops(get_model(name, bilinear=bilinear), *hw) == \
            JF.unet_forward_flops(jax_get_model(name, bilinear=bilinear), *hw)


@pytest.mark.parametrize("name", ["unet_pp_s", "yolov8_seg_s"])
def test_counted_flops_within_one_percent_of_jax_hlo(name):
    """FlopCounterMode's count (convs without their zero-padding taps, as
    XLA counts them) against XLA's cost analysis of the JAX forward at 64²;
    the rest is XLA's elementwise work (measured -0.42% and -0.96%)."""
    got = TF.forward_flops(get_model(name), 64, 64)
    want = JF.hlo_forward_flops(jax_get_model(name), 64, 64)
    assert abs(got / want - 1) < 0.01


def test_counted_flops_leave_out_the_padding():
    """A 3-tap SAME window over n positions does 3n - 2 products, so the
    counted unet_s forward at 64² lies below the closed form, which counts
    every tap."""
    model = unet_s()
    assert TF.forward_flops(model, 64, 64) < TF.unet_forward_flops(model, 64, 64)
    assert TF._taps(64, 3, pad=1) == 3 * 64 - 2 and TF._taps(64, 1) == 64


def test_plot_img_and_mask_under_agg(monkeypatch):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(len(plt.gcf().axes)))
    viz.plot_img_and_mask(np.zeros((8, 8)), np.array([[0, 1], [2, 2]]))
    assert shown == [4]  # the image and three classes
    plt.close("all")


def test_plot_without_matplotlib_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        viz.plot_img_and_mask(np.zeros((8, 8)), np.zeros((8, 8), np.int64))


# -- the CLIs' flags ------------------------------------------------------------

@pytest.mark.parametrize("flags,want", [
    (["--num-devices", "4"], dict(num_devices=4)),
    (["--distributed"], dict(distributed=True)),
    (["--coordinator-address", "h:1234"], dict(coordinator_address="h:1234")),
    (["--num-processes", "2", "--process-id", "1"], dict(num_processes=2, process_id=1)),
    (["--spatial-shards", "1"], dict(spatial_shards=1)),
])
def test_train_cli_parses_the_parallel_flags_as_jax(flags, want, monkeypatch):
    argv = ["--data-root", "d", *flags]
    monkeypatch.setattr("sys.argv", ["train", *argv])
    jax_args = vars(jax_train_cli.get_args())
    got = vars(train_cli.get_args(argv))
    for k, v in want.items():
        assert got[k] == jax_args[k] == v, k


@pytest.mark.parametrize("flags", [["--num-devices", "2"], ["--viz"], ["-v"]])
def test_predict_cli_parses_the_flags_as_jax(flags, monkeypatch):
    argv = ["-m", "a.npz", "-i", "x", *flags]
    monkeypatch.setattr("sys.argv", ["predict", *argv])
    jax_args = vars(jax_predict_cli.get_args())
    got = vars(predict_cli.get_args(argv))
    for k in ("num_devices", "viz"):
        assert got[k] == jax_args[k], k


@pytest.fixture
def png_dir(tmp_path):
    rng = np.random.default_rng(0)
    d = tmp_path / "imgs"
    d.mkdir()
    for name in ("a", "b", "c"):
        Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(d / f"{name}.png")
    return d


@pytest.fixture
def served_checkpoint(tmp_path):
    params, bn_state = random_unet_params(3)
    model = unet_s()
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, model)
    return model, path


def test_predict_cli_serves_data_parallel_and_plots(served_checkpoint, png_dir, tmp_path,
                                                    monkeypatch):
    """--num-devices 2 --device cpu: two CPU replicas write the masks of one
    Predictor; --viz plots each image beside its mask."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    model, ck = served_checkpoint
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(1))
    out = tmp_path / "masks"
    assert predict_cli.main(["-m", ck, "-i", str(png_dir), "-o", str(out), "--arch", "unet_s",
                             "--device", "cpu", "--no-postprocess", "--num-devices", "2",
                             "--viz"]) == 0
    plt.close("all")
    assert len(shown) == 3
    want = Predictor(model, device="cpu").predict_paths(
        collect_image_files(str(png_dir)), postprocess=False, save=False)
    from unet_medical_image_contour_segmentation_torch.engine.predict import mask_to_image

    for path, mask in want.items():
        np.testing.assert_array_equal(np.asarray(Image.open(out / os.path.basename(path))),
                                      np.asarray(mask_to_image(mask)))


def test_predict_cli_more_devices_than_cards_raises(served_checkpoint, png_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="exceeds the 1 CUDA devices"):
        predict_cli.main(["-m", served_checkpoint[1], "-i", str(png_dir), "--arch", "unet_s",
                          "--num-devices", "2", "--no-save"])


@pytest.fixture
def data_root(tmp_path):
    rng = np.random.default_rng(0)
    for split, n in (("train", 4), ("val", 2)):
        (tmp_path / "imgs" / split).mkdir(parents=True)
        (tmp_path / "masks" / split).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (64, 64), dtype=np.uint8)).save(
                tmp_path / "imgs" / split / f"case{i}.png")
            Image.fromarray(rng.choice([0, 128, 255], (64, 64)).astype(np.uint8)).save(
                tmp_path / "masks" / split / f"case{i}_mask.png")
    return tmp_path


TRAIN_ARGV = ["--epochs", "1", "-b", "4", "--model", "unet_t", "--scale", "0.5", "--no-amp",
              "--no-save-val-predictions", "--no-val-postprocess", "--device", "cpu",
              "--sample-cache-gb", "0.01"]


def test_train_cli_num_devices_2(data_root, tmp_path, monkeypatch):
    """--num-devices 2 on the CPU: train_model spawns two ranks (the dataset,
    RAM cache and all, pickles into them); 16 augmented samples at global
    batch 4 make 4 steps, and rank 0 writes the checkpoint."""
    monkeypatch.chdir(tmp_path)
    assert train_cli.main(["--data-root", str(data_root), *TRAIN_ARGV,
                           "--num-devices", "2"]) == 0
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 4


def test_train_cli_multi_host_flags(data_root, tmp_path):
    """Two processes, each the train CLI with --distributed, a coordinator
    (a file:// rendezvous), --num-processes 2 and its --process-id: both
    train the 4 steps and leave the group; rank 0 writes the checkpoint."""
    got = run_ranks(train_cli_rank, (["--data-root", str(data_root), *TRAIN_ARGV],
                                     str(tmp_path)), tmp_path, join=False)
    assert got == [(0, False), (0, False)]
    assert load_checkpoint(str(tmp_path / "model_epoch1.npz"))["step"] == 4
