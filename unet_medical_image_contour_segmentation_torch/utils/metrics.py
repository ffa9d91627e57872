"""Structured metric logging: per-step JSONL + pluggable backends.

The port's own copy of the JAX package's ``utils/metrics.py``.  One JSON
object per event goes to a ``metrics.jsonl`` (loss terms, Dice triples,
learning rate, throughput), and any callable ``(kind, record)`` can be
registered as an experiment-tracker backend.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Callable, Iterable, Optional

__all__ = ["MetricLogger"]

log = logging.getLogger(__name__)

# (kind, record) -> None; record is the flattened float/str field dict
Backend = Callable[[str, dict], None]


class MetricLogger:
    def __init__(self, path: Optional[str] = None,
                 backends: Optional[Iterable[Backend]] = None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._start = time.time()
        self._backends = list(backends or ())

    def add_backend(self, backend: Backend) -> None:
        """Register an experiment-tracker hook, called once per record from
        the next :meth:`log` on (with or without a file)."""
        self._backends.append(backend)

    def log(self, kind: str, **fields):
        if self._fh is None and not self._backends:
            return
        record = {"t": round(time.time() - self._start, 3), "kind": kind}
        for k, v in fields.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
        for backend in self._backends:
            try:
                backend(kind, record)
            except Exception:
                # a tracker outage must never kill the training loop
                log.exception("metric backend %r failed", backend)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
