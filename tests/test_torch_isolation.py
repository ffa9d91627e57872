"""The port imports neither JAX nor the JAX package, and chip_smoke.py and
int8_kernel_ab.py neither."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "unet_medical_image_contour_segmentation_torch"
FORBIDDEN = ("jax", "jaxlib", "unet_medical_image_contour_segmentation_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "int8_kernel_ab.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("module", ["models/quantize.py", "kernels/conv3x3_int8.py"])
def test_int8_modules_are_checked(module):
    """The int8 serving modules are among the sources checked above."""
    assert PORT / module in _sources()


@pytest.mark.parametrize("module", ["models/unet_nested.py", "models/yolov8_seg.py"])
def test_model_family_modules_are_checked(module):
    """UNet++ and YOLOv8-seg are among the sources checked above."""
    assert PORT / module in _sources()


@pytest.mark.parametrize("module", ["parallel/data_parallel.py", "parallel/distributed.py",
                                    "ops/collectives.py", "utils/profiling.py",
                                    "utils/version_info.py", "utils/viz.py", "utils/flops.py",
                                    "parallel/spatial.py", "ops/halo.py"])
def test_parallel_and_utils_modules_are_checked(module):
    """Data and spatial parallelism and the utils are among the sources
    checked above."""
    assert PORT / module in _sources()


@pytest.mark.parametrize("module", ["utils/compile_cache.py", "kernels/_build.py",
                                    "engine/checkpoint.py", "engine/train.py",
                                    "engine/evaluate.py", "engine/optim.py", "data/loader.py",
                                    "data/dataset.py", "utils/metrics.py", "__init__.py",
                                    "data/__init__.py", "engine/__init__.py",
                                    "losses/__init__.py", "models/__init__.py",
                                    "ops/__init__.py", "utils/__init__.py",
                                    "parallel/__init__.py"])
def test_api_checkpoint_and_prefetch_modules_are_checked(module):
    """The public API's package files, the build directory, the checkpoint
    writer, the train loop and the prefetch are among the sources checked
    above."""
    assert PORT / module in _sources()


def test_rank_bodies_import_no_jax():
    """The module that the data-parallel tests' spawned ranks import stays
    free of JAX too."""
    test_no_forbidden_import_in_source(REPO / "tests" / "torch_dp_ranks.py")


def test_spatial_rank_bodies_import_no_jax():
    """So does the spatial-parallel tests' (tests/torch_spatial_ranks.py)."""
    test_no_forbidden_import_in_source(REPO / "tests" / "torch_spatial_ranks.py")


def test_importing_everything_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import unet_medical_image_contour_segmentation_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules if n.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ISOLATED", len([n for n in sys.modules if n.startswith(port.__name__)]))
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ISOLATED" in r.stdout


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """With no card, chip_smoke exits nonzero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke would run")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
                       text=True, timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Copied without the rest of the repo, chip_smoke.py cannot run."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
