"""Tracing helpers, the port's counterpart of the JAX package's
``utils/profiling.py``: ``torch.profiler`` in place of ``jax.profiler``, and
the program's own spans.

A span (:func:`span`) records where the host spent its time inside the
program: its name, start and end (``time.perf_counter_ns``), the span it
lies in, its thread, the call it belongs to and its attributes (counts made
at the same boundary).  A span opened outside any other opens a new call;
the spans inside it share its call id.  Tracing is off by default, and a
span then costs one flag test and returns a shared do-nothing context.
:func:`enable` turns it on: the records stay in memory, at most
``MAX_SPANS`` of them (later ones are dropped, with a warning), until
:func:`collect` returns them.  While a ``torch.profiler`` is recording, each
span also opens ``record_function("umics.<name>")``, so that it lies on the
profiler's timeline above the device work it launched; :func:`trace` turns
the spans on for its block.

The spans, and the calls they belong to:

* ``predict`` (``slices``, ``chunks``): one ``predict_array`` call; inside
  it ``predict.upload`` (the host images to the device), ``predict.forward``
  (launching the forward and the class map; the tiled path as a whole) and
  ``predict.fetch`` (``route``: ``pinned`` or ``host``, ``bytes``: the
  map's; each chunk's class map to the host: the wait on the card, the copy
  into the pinned staging buffer and the widening into the int32 result);
* ``train.step``: one ``TrainStep`` call; inside it ``train.forward``,
  ``train.loss``, ``train.backward`` (with ``zero_grad``), ``train.clip``
  and ``train.optimizer`` (setting the lr and the step);
* ``transunet.resnet``, ``transunet.transformer``, ``transunet.decoder``:
  the three stages of a TransUNet forward (``models/transunet.py``), inside
  ``predict.forward`` or ``train.forward``;
* ``loader.wait``: one ``next()`` of ``prefetch_to_device``;
* ``setup.kernels`` (``kernel``, ``built``: nvcc ran): a hand kernel's
  library built or loaded; ``setup.predictor``: ``Predictor``'s
  construction (the BN fold, the casts, the replicas).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

__all__ = ["trace", "span", "enable", "disable", "collect", "Span", "MAX_SPANS",
           "device_memory_stats"]

log = logging.getLogger(__name__)

# records kept between two collect() calls: about 200 bytes each
MAX_SPANS = 100_000


class Span:
    """One finished (or open) span; ``span["key"] = value`` sets an attribute."""

    __slots__ = ("name", "id", "parent", "call", "thread", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, id: int, parent: Optional[int], call: int, thread: int,
                 attrs: dict):
        self.name, self.id, self.parent, self.call = name, id, parent, call
        self.thread, self.attrs = thread, attrs
        self.start_ns = self.end_ns = 0

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"{(self.end_ns - self.start_ns) / 1e3:.1f} us, {self.attrs})")


class _Off:
    """The shared context of a span while tracing is off: does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key, value) -> None:
        pass


_OFF = _Off()
_on = False
_records: List[Span] = []
_dropped = 0
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()


class _On:
    __slots__ = ("name", "attrs", "record", "annotation")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Span:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        rec = Span(self.name, next(_ids), parent and parent.id,
                   parent.call if parent else next(_calls), threading.get_ident(), self.attrs)
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = record_function(f"umics.{self.name}")
            self.annotation.__enter__()
        stack.append(rec)
        self.record = rec
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        global _dropped
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            if not _dropped:
                log.warning("span buffer full at %d records: later spans are dropped until "
                            "collect()", MAX_SPANS)
            _dropped += 1
        return False


def span(name: str, **attrs):
    """A context manager timing the block as the span ``name`` (see the
    module docstring); it yields the :class:`Span`, or a stand-in that
    ignores attributes while tracing is off."""
    if not _on:
        return _OFF
    return _On(name, attrs)


def enable() -> None:
    """Record spans from now on (the records already kept stay)."""
    global _on
    _on = True


def disable() -> None:
    """Stop recording spans; the records kept stay until :func:`collect`."""
    global _on
    _on = False


def collect() -> List[Span]:
    """The spans finished since the last call, in the order they ended, and
    clear them."""
    global _records, _dropped
    out, _records, _dropped = _records, [], 0
    return out


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` trace of the block (CPU and, with a card, CUDA
    activity), written to ``log_dir`` as a Chrome trace for TensorBoard or
    Perfetto, with the program's spans on for the block (``umics.*`` above
    the device work they launched; when tracing was off before, they are not
    kept for :func:`collect`); yields the profiler (None when ``enabled`` is
    false)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was_on, kept = _on, len(_records)
    enable()
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
            yield prof
    finally:
        if not was_on:
            disable()
            del _records[kept:]  # the block's spans are in its trace


def device_memory_stats() -> Dict[str, dict]:
    """``torch.cuda.memory_stats`` of every CUDA device, by device name
    (``cuda:0``, ...); ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
