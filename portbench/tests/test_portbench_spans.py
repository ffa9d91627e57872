"""The program's spans stay off in a benchmark run: nothing is recorded,
and the traced breakdown's idle-gap labels and convs hold no ``umics.*``
span of the program, so they keep their meaning."""

import pytest
import torch

from portbench import harness
from unet_medical_image_contour_segmentation_torch.utils import profiling

from .small import small_spec

SEED = 2**33 + 29


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["unet_s.serve_interactive", "unet_s.train"])
def test_run_records_no_span_and_labels_no_umics_name(cell, trace):
    profiling.collect()
    run = harness.execute(small_spec(cell), SEED, 0.3, bool(trace), torch.device("cpu"))
    line = harness.result_line(run)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert profiling.collect() == []
    if trace:
        labels = [name for name, _ in line["breakdown"]["idle_gaps"]]
        labels += [c.name for c in run.profile.convs]
        assert labels and not any(name.startswith("umics.") for name in labels)
