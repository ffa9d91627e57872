"""On the card, at each cell's own size: the program as the benchmark runs
it comes out correct, and the control in its place (the program's int8
serving, the reference's float8 step) does not.  Run there with
``python -m pytest portbench/tests/test_portbench_gpu.py -m gpu``."""

import pytest
import torch

from portbench import harness

pytestmark = pytest.mark.gpu
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    harness.set_cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell):
    run = harness.execute(harness.cell_spec(cell), 2**32 + 11, 1.0, False, _card())
    assert run.correct, run.checks


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    run = harness.execute(harness.cell_spec(cell), 2**32 + 12, 1.0, False, _card(),
                          control=True)
    assert not run.correct, run.checks
