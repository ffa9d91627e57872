"""The program's spans (``utils/profiling.py``): off by default, where a span
is a flag test and records nothing; their nesting, call ids, threads and
buffer bound; their ``umics.*`` annotations on a ``torch.profiler``
timeline; and where the port opens them: a served call, a train step, the
prefetch and a kernel library's load."""

import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from unet_medical_image_contour_segmentation_torch.data.loader import prefetch_to_device
from unet_medical_image_contour_segmentation_torch.engine.optim import RMSpropConfig
from unet_medical_image_contour_segmentation_torch.engine.predict import Predictor
from unet_medical_image_contour_segmentation_torch.engine.train import TrainStep
from unet_medical_image_contour_segmentation_torch.kernels import _build
from unet_medical_image_contour_segmentation_torch.losses.compound import LossConfig
from unet_medical_image_contour_segmentation_torch.models.unet import unet_s
from unet_medical_image_contour_segmentation_torch.utils import profiling

CPU = [torch.profiler.ProfilerActivity.CPU]
TRAIN_CHILDREN = ["train.forward", "train.loss", "train.backward", "train.clip",
                  "train.optimizer"]


@pytest.fixture(autouse=True)
def _tracing_off():
    profiling.disable()
    profiling.collect()
    yield
    profiling.disable()
    profiling.collect()


@pytest.fixture
def traced():
    profiling.enable()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return unet_s()


def _images(n=3):
    return np.random.default_rng(0).integers(0, 256, (n, 32, 32), dtype=np.uint8)


def _batch():
    g = torch.Generator().manual_seed(0)
    return {"image": torch.rand((2, 32, 32, 1), generator=g),
            "mask": torch.randint(0, 3, (2, 32, 32), generator=g, dtype=torch.int32)}


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent.id), key=lambda r: r.start_ns)


def _within(child, parent):
    return parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_off_records_nothing_and_returns_the_null_context():
    ctx = profiling.span("a", slices=1)
    assert ctx is profiling.span("b")
    with ctx as s:
        s["built"] = True
        with profiling.span("c"):
            pass
    assert profiling.collect() == []


def test_off_opens_no_annotation_in_the_port_under_a_profiler(model, monkeypatch):
    """With tracing off, a served call, a train step and the prefetch open
    no ``record_function`` and record nothing, though a profiler runs."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with tracing off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    with torch.profiler.profile(activities=CPU) as prof:
        Predictor(model, device="cpu").predict_array(_images())
        TrainStep(unet_s(), LossConfig(), RMSpropConfig(learning_rate=1e-4))(_batch(), 1e-4)
        list(prefetch_to_device(iter([{"mask": np.zeros((1, 2), np.int32)}]), "cpu"))
    assert profiling.collect() == []
    assert not any(e.name.startswith("umics.") for e in prof.events())


def test_nesting_gives_parents_and_call_ids(traced):
    with profiling.span("a", slices=4) as a:
        with profiling.span("b") as b:
            with profiling.span("c") as c:
                pass
        with profiling.span("d") as d:
            d["built"] = False
    with profiling.span("e") as e:
        pass
    recs = profiling.collect()
    assert [r.name for r in recs] == ["c", "b", "d", "a", "e"]
    assert (a.parent, b.parent, c.parent, d.parent, e.parent) == (None, a.id, b.id, a.id, None)
    assert a.call == b.call == c.call == d.call != e.call
    assert a.attrs == {"slices": 4} and d.attrs == {"built": False}
    assert _within(b, a) and _within(c, b) and _within(d, a) and b.end_ns <= d.start_ns
    assert profiling.collect() == []


def test_call_ids_and_stacks_are_per_thread(traced):
    """Two threads' roots open at once: each is a root with its own call,
    and each child lies under its own thread's root."""
    both = threading.Barrier(2)

    def work():
        with profiling.span("root"):
            both.wait(timeout=10)
            with profiling.span("child"):
                both.wait(timeout=10)

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.collect()
    roots = {r.id: r for r in recs if r.name == "root"}
    children = [r for r in recs if r.name == "child"]
    assert len(roots) == 2 and len(children) == 2
    assert all(r.parent is None for r in roots.values())
    assert len({r.call for r in roots.values()}) == 2
    for c in children:
        root = roots[c.parent]
        assert c.call == root.call and c.thread == root.thread and _within(c, root)


def test_buffer_bound_holds(traced, monkeypatch, caplog):
    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    for i in range(12):
        with profiling.span("s", i=i):
            pass
    assert [r.attrs["i"] for r in profiling.collect()] == list(range(5))
    assert caplog.text.count("span buffer full") == 1
    with profiling.span("s", i=99):
        pass
    assert [r.attrs["i"] for r in profiling.collect()] == [99]


def test_spans_lie_on_the_profiler_timeline_nested(traced):
    with torch.profiler.profile(activities=CPU) as prof:
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(64).sum()
    events = prof.events()
    marks = {e.name: e for e in events if e.name.startswith("umics.")}
    assert set(marks) == {"umics.outer", "umics.inner"}
    outer, inner = marks["umics.outer"].time_range, marks["umics.inner"].time_range
    assert outer.start <= inner.start <= inner.end <= outer.end
    sums = [e.time_range for e in events if e.name == "aten::sum"]
    assert sums and all(inner.start <= s.start <= s.end <= inner.end for s in sums)
    assert [r.name for r in profiling.collect()] == ["inner", "outer"]


def test_trace_turns_the_spans_on_for_its_block(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("block"):
            torch.ones(8).sum()
    assert profiling.span("a") is profiling.span("b")  # off again
    assert profiling.collect() == []                   # the block's spans are in its trace
    chrome = "".join(p.read_text() for p in tmp_path.rglob("*.json"))
    assert '"umics.block"' in chrome


def test_predict_array_emits_predict_and_its_three_children(model, traced):
    pred = Predictor(model, device="cpu", batch_size=2)
    assert [r.name for r in profiling.collect()] == ["setup.predictor"]
    out = pred.predict_array(_images(3))
    assert out.shape == (3, 32, 32)
    recs = profiling.collect()
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "predict" and root.attrs == {"slices": 3, "chunks": 2}
    kids = _children(recs, root)
    assert [r.name for r in kids] == ["predict.upload", "predict.forward", "predict.fetch"] * 2
    assert [r.attrs for r in kids if r.name == "predict.fetch"] == [
        {"route": "host", "bytes": 2 * 32 * 32}, {"route": "host", "bytes": 32 * 32}]
    assert len(recs) == 7
    assert all(r.call == root.call and _within(r, root) for r in kids)


def test_train_step_emits_its_five_children(traced):
    torch.manual_seed(0)
    step = TrainStep(unet_s(), LossConfig(), RMSpropConfig(learning_rate=1e-4))
    metrics = step(_batch(), 1e-4)
    assert torch.isfinite(metrics["loss"])
    recs = profiling.collect()
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "train.step"
    kids = _children(recs, root)
    assert [r.name for r in kids] == TRAIN_CHILDREN and len(recs) == 6
    assert all(r.call == root.call and _within(r, root) for r in kids)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))


def test_prefetch_emits_a_wait_per_next(traced):
    batches = [{"mask": np.full((1, 2), i, np.int32)} for i in range(4)]
    out = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["mask"][0, 0]) for b in out] == [0, 1, 2, 3]
    waits = [r for r in profiling.collect() if r.name == "loader.wait"]
    # one per next(), the last the one that found the end
    assert len(waits) == 5
    assert all(r.parent is None for r in waits) and len({r.call for r in waits}) == 5


@pytest.mark.parametrize("seconds, built", [(0.0, False), (2.5, True)])
def test_kernel_load_span_says_whether_nvcc_ran(monkeypatch, traced, seconds, built):
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda names: {
        n: _build.BuildResult(n, Path(f"{n}.so"), "", seconds) for n in names})
    monkeypatch.setattr(_build, "ctypes", types.SimpleNamespace(CDLL=lambda path: ("lib", path)))
    assert _build.load_library("conv3x3") == ("lib", "conv3x3.so")
    assert _build.load_library("conv3x3") == ("lib", "conv3x3.so")  # loaded once
    (rec,) = profiling.collect()
    assert rec.name == "setup.kernels" and rec.attrs == {"kernel": "conv3x3", "built": built}
