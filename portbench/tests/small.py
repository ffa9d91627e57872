"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second, for
the benchmark's own tests: 64² slices, a few of them, batches of 2."""

import torch

from portbench import harness

SMALL_SLICES = dict(height=64, width=64, center_margin=16.0, radius_min=6.0, radius_max=20.0)
SMALL_TRAFFIC = {"serve_closed": dict(pool=8, warmup_calls=3, trace_calls=2, trace_detail_calls=2,
                                      sample_extra=2),
                 "train_loop": dict(pool_batches=4, batch=2, warmup_steps=2, trace_steps=2,
                                    trace_detail_steps=2)}


def small_spec(name: str, **config) -> harness.Spec:
    """The cell ``name`` at the small size; ``config`` overrides fields of its
    configuration (``compute_dtype="float32"`` for an exact-enough program).
    Torch gets two threads: the tests run in several processes at once."""
    torch.set_num_threads(2)
    spec = harness.cell_spec(name)
    spec.slices = dict(spec.slices, **SMALL_SLICES)
    traffic = dict(spec.traffic, **SMALL_TRAFFIC[spec.traffic["driver"]])
    if traffic["driver"] == "serve_closed":
        traffic["batch"] = min(traffic["batch"], 2)
    spec.traffic = traffic
    spec.config = dict(spec.config, **config)
    return spec
