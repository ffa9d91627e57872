"""Each cell driven on the CPU at a small size through the harness's own
entry (``run.py`` refuses to run without a card), sound and with the timed
path broken underneath: a broken path has to come out not correct."""

import numpy as np
import pytest
import torch

from portbench import harness
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
from unet_medical_image_contour_segmentation_torch.models import blocks

from .small import small_spec

CPU = torch.device("cpu")
SEED = 2**33 + 17  # run seeds may take more than 32 bits
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _run(spec, trace=False):
    return harness.execute(spec, SEED, 0.3, trace, CPU)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_reports_its_metrics(cell, trace):
    run = _run(small_spec(cell), trace)
    line = harness.result_line(run)
    assert set(line) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(line)[-1] == "checks" and line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if trace:
        assert line["device"]["window_s"] > 0 and "breakdown" in line
        # no card: no device-trace reading, and none reads 0 in its place
        assert all(m["source"] != "device_trace"
                   for m in run.spec.per_layer if m["name"] in line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in run.spec.end_to_end}
        assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_f32_run_is_correct(cell):
    # the program in f32 against the f32 reference: within every limit
    assert _run(small_spec(cell, compute_dtype="float32")).correct


def test_same_seed_same_inputs_and_weights():
    # only the first pass over the pool is compared: which later calls the
    # reservoir keeps depends on how many calls the window made
    spec = small_spec("unet_s.serve_batch")
    spec.traffic = dict(spec.traffic, sample_extra=0)
    a, b = (harness.execute(spec, SEED, 1.0, False, CPU) for _ in range(2))
    assert a.notes["compared"] == b.notes["compared"]
    assert [c[1] for c in a.checks] == [c[1] for c in b.checks]


@pytest.mark.parametrize("cell", [c for c in CELLS if "serve" in c])
def test_altered_answer_is_not_correct(cell, monkeypatch):
    serve = Predictor.predict_array

    def altered(self, images, out_hw=None):
        out = serve(self, images, out_hw)
        out[0] = (out[0] + 1) % 3  # the first slice's answer, where it is produced
        return out

    monkeypatch.setattr(Predictor, "predict_array", altered)
    assert not _run(small_spec(cell, compute_dtype="float32")).correct


def test_unchanged_state_is_not_correct(monkeypatch):
    step = TrainStep.__call__

    def unchanged(self, batch, lr):
        saved = [p.detach().clone() for p in self.params]
        out = step(self, batch, lr)
        with torch.no_grad():
            for p, s in zip(self.params, saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(TrainStep, "__call__", unchanged)
    run = _run(small_spec("unet_s.train", compute_dtype="float32"))
    assert not run.correct and dict((n, v) for n, v, _ in run.checks)["change_gap"] == 1.0


def test_unmoved_bn_statistics_are_not_correct(monkeypatch):
    # the trained model is served on the running statistics the steps move
    bn_apply = blocks._bn_apply

    def frozen(bn, y, train, group=None):
        saved = bn.running_mean.clone(), bn.running_var.clone()
        out = bn_apply(bn, y, train, group)
        with torch.no_grad():
            bn.running_mean.copy_(saved[0])
            bn.running_var.copy_(saved[1])
        return out

    monkeypatch.setattr(blocks, "_bn_apply", frozen)
    run = _run(small_spec("unet_s.train", compute_dtype="float32"))
    # no statistic moved: every tensor at or above the median reads 1
    assert not run.correct and dict((n, v) for n, v, _ in run.checks)["bn_stats_gap.median"] > 0.9


def test_half_batch_is_not_correct(monkeypatch):
    step = TrainStep.__call__
    monkeypatch.setattr(TrainStep, "__call__", lambda self, batch, lr: step(
        self, {k: v[:len(v) // 2] for k, v in batch.items()}, lr))
    assert not _run(small_spec("unet_s.train", compute_dtype="float32")).correct


def test_failed_call_is_counted_and_not_correct(monkeypatch):
    calls = {"n": 0}
    serve = Predictor.predict_array

    def flaky(self, images, out_hw=None):
        calls["n"] += 1
        if calls["n"] == 4:  # the first call of the window, after 3 warm-up calls
            raise RuntimeError("lost")
        return serve(self, images, out_hw)

    monkeypatch.setattr(Predictor, "predict_array", flaky)
    run = _run(small_spec("unet_s.serve_batch", compute_dtype="float32"))
    assert run.failed == 1 and not run.correct


def test_control_runs_on_the_cpu():
    # the program's int8 serving and the reference's float8 step run here;
    # whether they fail the limits is shown on the card (test_portbench_gpu)
    for cell in ("unet_s.serve_batch", "unet_s.train"):
        run = harness.execute(small_spec(cell), SEED, 0.3, False, CPU, control=True)
        assert all(np.isfinite(v) for _, v, _ in run.checks)
