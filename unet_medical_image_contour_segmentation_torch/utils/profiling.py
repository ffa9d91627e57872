"""Tracing and timing helpers, the port's counterpart of the JAX package's
``utils/profiling.py``: ``torch.profiler`` in place of ``jax.profiler``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

__all__ = ["trace", "StepTimer", "device_memory_stats"]


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True) -> Iterator[Optional[torch.profiler.profile]]:
    """A ``torch.profiler`` trace of the block (CPU and, with a card, CUDA
    activity), written to ``log_dir`` as a Chrome trace for TensorBoard or
    Perfetto; yields the profiler (None when ``enabled`` is false)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


class StepTimer:
    """Items per second on the host clock, the first ``warmup`` steps left
    out.  Work queued on a card is timed only when the caller synchronises
    before each :meth:`step` (``torch.cuda.synchronize``)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.items = 0
        self._t0: Optional[float] = None

    def step(self, n_items: int = 1) -> None:
        self.count += 1
        if self.count == self.warmup:
            self._t0 = time.perf_counter()
            self.items = 0
        elif self.count > self.warmup:
            self.items += n_items

    @property
    def items_per_sec(self) -> Optional[float]:
        if self._t0 is None or self.items == 0:
            return None
        return self.items / (time.perf_counter() - self._t0)


def device_memory_stats() -> Dict[str, dict]:
    """``torch.cuda.memory_stats`` of every CUDA device, by device name
    (``cuda:0``, ...); ``{}`` without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i) for i in range(torch.cuda.device_count())}
