"""The port's public API, kernel build directory, CarvanaDataset,
``sample_name``, ``MetricLogger.add_backend`` and ``make_eval_step``, on the
CPU, against the JAX package's counterparts."""

import ast
import importlib
import re
import stat
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import random_unet_params
from unet_medical_image_contour_segmentation_torch.data.dataset import (
    BasicDataset,
    CarvanaDataset,
)
from unet_medical_image_contour_segmentation_torch.engine.evaluate import make_eval_step
from unet_medical_image_contour_segmentation_torch.kernels import _build
from unet_medical_image_contour_segmentation_torch.models.torch_compat import (
    state_dict_from_jax,
)
from unet_medical_image_contour_segmentation_torch.models.unet import unet_t
from unet_medical_image_contour_segmentation_torch.utils import compile_cache
from unet_medical_image_contour_segmentation_torch.utils.metrics import MetricLogger
from unet_medical_image_contour_segmentation_tpu.data import dataset as JD
from unet_medical_image_contour_segmentation_tpu.engine.evaluate import (
    make_eval_step as jax_make_eval_step,
)
from unet_medical_image_contour_segmentation_tpu.models.unet import unet_t as jax_unet_t
from unet_medical_image_contour_segmentation_tpu.utils import metrics as JM

REPO = Path(__file__).resolve().parent.parent
PORT = "unet_medical_image_contour_segmentation_torch"
JAX_PKG = REPO / "unet_medical_image_contour_segmentation_tpu"
SUBPACKAGES = ["", "data", "engine", "losses", "models", "ops", "utils", "parallel", "pipeline"]
# a JAX name the port gives another name, in a package docstring: ``jax`` -> ``port``
RENAMED = re.compile(r"``(\w+)`` -> ``(\w+)``")


def _jax_all(sub: str) -> list:
    """The ``__all__`` of a JAX (sub)package's ``__init__.py``, read by AST."""
    tree = ast.parse((JAX_PKG / sub / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {sub or 'the top level'}")


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=lambda s: s or "top")
def test_every_jax_export_has_its_counterpart(sub):
    port = importlib.import_module(f"{PORT}.{sub}" if sub else PORT)
    renamed = dict(RENAMED.findall(port.__doc__ or ""))
    for name in _jax_all(sub):
        here = renamed.get(name, name)
        assert here in port.__all__ and hasattr(port, here), (sub, name, here)
    assert all(hasattr(port, name) for name in port.__all__)


def test_the_public_imports_load_no_host_library_and_build_nothing():
    """The JAX import lines work on the port, and import no jax, cv2, PIL or
    matplotlib, and build no kernel."""
    code = f"""
import sys
from {PORT} import UNet, get_model, unet, unet_s, unet_sa, unet_t
from {PORT}.models import get_model, MODEL_REGISTRY
from {PORT}.data import CarvanaDataset, DataLoader, prefetch_to_device
from {PORT}.engine import save_checkpoint_async, make_eval_step, train_model
from {PORT}.losses import compute_loss
from {PORT}.ops import conv2d
from {PORT}.utils import plot_img_and_mask
from {PORT}.kernels import _build
assert unet_s().name == "unet_s" and get_model("unet_t").name == "unet_t"
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "cv2", "PIL", "matplotlib"))
assert not bad, bad
assert not _build._loaded
print("CLEAN")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "CLEAN" in r.stdout


def test_build_dir_of_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    assert compile_cache.kernel_build_dir() == REPO / "build" / "torch_kernels"


def test_build_dir_of_an_installed_package(tmp_path, monkeypatch):
    """Installed, the package's parent is site-packages: no checkout there,
    so the kernels build under the user's cache, outside that tree."""
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    site = tmp_path / "prefix" / "lib" / "python3.12" / "site-packages"
    (site / PORT).mkdir(parents=True)
    got = compile_cache.kernel_build_dir(site / PORT)
    assert got == tmp_path / "home" / ".cache" / "umics" / "torch_kernels"
    assert site not in got.parents and site.parent not in got.parents


def test_build_dir_needs_this_projects_pyproject(tmp_path, monkeypatch):
    monkeypatch.delenv(compile_cache.CACHE_DIR_ENV, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    (tmp_path / "other" / PORT).mkdir(parents=True)
    (tmp_path / "other" / "pyproject.toml").write_text('[project]\nname = "other"\n')
    home_cache = tmp_path / "home" / ".cache" / "umics" / "torch_kernels"
    assert compile_cache.kernel_build_dir(tmp_path / "other" / PORT) == home_cache
    (tmp_path / "other" / "pyproject.toml").write_text((REPO / "pyproject.toml").read_text())
    assert (compile_cache.kernel_build_dir(tmp_path / "other" / PORT)
            == tmp_path / "other" / "build" / "torch_kernels")


@pytest.mark.parametrize("where", ["checkout", "installed"])
def test_build_dir_env_override(tmp_path, monkeypatch, where):
    """``UMICS_COMPILE_CACHE_DIR``, the JAX package's variable, wins in every layout."""
    monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path / "cache"))
    package = REPO / PORT if where == "checkout" else tmp_path / "site-packages" / PORT
    assert compile_cache.kernel_build_dir(package) == tmp_path / "cache" / "torch_kernels"


def _fake_nvcc(tmp_path, exit_code: int) -> Path:
    """A CUDA_HOME whose nvcc writes an empty library (or fails)."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
                    f'echo "ptxas info    : Used 1 registers"\n: > "$out"\nexit {exit_code}\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return tmp_path / "cuda"


def test_build_writes_into_the_resolved_dir(tmp_path, monkeypatch):
    """The build directory is resolved at the build, not at import: an
    override set now takes the library, once; the source hash names it."""
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, 0)))
    monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path / "cache"))
    first = _build.build(["conv3x3"])["conv3x3"]
    assert first.library.parent == tmp_path / "cache" / "torch_kernels"
    assert re.fullmatch(r"conv3x3-[0-9a-f]{16}\.so", first.library.name)
    assert first.library.exists() and "Used 1 registers" in first.log
    again = _build.build(["conv3x3"])["conv3x3"]
    assert (again.library, again.seconds) == (first.library, 0.0)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, 1)))
    monkeypatch.setenv(compile_cache.CACHE_DIR_ENV, str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build(["conv3x3"])
    built = (tmp_path / "cache" / "torch_kernels").iterdir()
    assert not [p.name for p in built if re.fullmatch(r"conv3x3-[0-9a-f]{16}\.so", p.name)]


@pytest.fixture
def carvana_root(tmp_path):
    rng = np.random.default_rng(5)
    (tmp_path / "imgs").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (24, 40), dtype=np.uint8)).save(
            tmp_path / "imgs" / f"car{i}.png")
        Image.fromarray(rng.choice([0, 128, 255], (24, 40)).astype(np.uint8)).save(
            tmp_path / "masks" / f"car{i}_mask.png")
    return tmp_path


@pytest.mark.parametrize("augment", [True, False])
def test_carvana_dataset_and_sample_name_match_jax(carvana_root, augment):
    ours = CarvanaDataset(carvana_root / "imgs", carvana_root / "masks", 0.5, augment=augment)
    theirs = JD.CarvanaDataset(carvana_root / "imgs", carvana_root / "masks", 0.5,
                               augment=augment)
    assert isinstance(ours, BasicDataset) and ours.mask_suffix == "_mask"
    assert len(ours) == len(theirs) == 3 * (4 if augment else 1)
    assert ours.ids == theirs.ids and ours.mask_values == theirs.mask_values
    for i in range(len(ours)):
        assert ours.sample_name(i) == theirs.sample_name(i)
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["mask"], b["mask"])


def test_add_backend_matches_jax():
    """A backend added after construction gets every later record, with no
    file, as JAX's; the records agree but for the time field."""
    got, want = [], []
    for cls, seen in ((MetricLogger, got), (JM.MetricLogger, want)):
        mlog = cls()
        mlog.log("train_step", step=0, loss=1.0)  # no file, no backend: dropped
        mlog.add_backend(lambda kind, rec, seen=seen: seen.append((kind, rec)))
        mlog.log("train_step", step=1, loss=np.float32(0.5), note="x")
        mlog.log("validation", epoch=1, dice=0.25)
        mlog.close()
    strip = [(kind, {k: v for k, v in rec.items() if k != "t"}) for kind, rec in got]
    assert strip == [(kind, {k: v for k, v in rec.items() if k != "t"}) for kind, rec in want]
    assert [kind for kind, _ in got] == ["train_step", "validation"]


@pytest.mark.parametrize("n_classes", [3, 1])
def test_make_eval_step_matches_jax(n_classes):
    """JAX's make_eval_step and the port's on the same unet_t weights: the
    same class maps (f32; a pixel may flip only at a near-tie)."""
    params, bn_state = random_unet_params(3, widths=(8, 16, 32, 64, 128), n_classes=n_classes)
    image = np.random.default_rng(7).random((2, 64, 64, 1), dtype=np.float32)
    want = np.asarray(jax_make_eval_step(jax_unet_t(1, n_classes), n_classes)(
        params, bn_state, jnp.asarray(image)))
    model = unet_t(n_classes=n_classes)
    model.load_state_dict(state_dict_from_jax(params, bn_state))
    model.train()
    got = make_eval_step(model, n_classes)(torch.from_numpy(image))
    assert model.training  # the step restores the mode it found
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 64, 64)
    assert (got.numpy() != want).mean() < 1e-3
    assert len(np.unique(want)) > 1
