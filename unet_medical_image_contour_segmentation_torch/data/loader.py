"""Batched, multi-worker input pipeline with a one-batch-ahead device copy.

The port's counterpart of the JAX package's ``data/loader.py``: a thread
pool decodes and augments samples (PIL and numpy release the GIL) and
batches are stacked channel-last.  :func:`prefetch_to_device` pins batches
in a background thread and issues each batch's host-to-card copy
(``non_blocking``, from pinned memory) before the previous batch is handed
out.  The copy is queued on the current stream, ahead of the step that
takes the previous batch: the host never waits for it, but on the card it
does not run beside a kernel (a side copy stream would be a later change).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DataLoader", "prefetch_to_device"]


class DataLoader:
    """Epoch iterator over an indexable dataset of dict samples: a seeded
    shuffle per epoch, optional ``drop_last``, ``num_workers`` threads.

    ``process_slice``: when data-parallel, this rank's rows of every
    globally ordered batch (``parallel/distributed.py:local_batch_slice``);
    the rank decodes only those.  The shuffle is seeded, so every rank
    agrees on the global batches without talking."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, num_workers: int = 8, seed: int = 0,
                 process_slice: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.process_slice = process_slice
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            for b in range(len(self)):
                idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                if self.process_slice is not None:
                    idxs = idxs[self.process_slice]
                samples = list(ex.map(self.dataset.__getitem__, idxs))
                yield {k: np.stack([s[k] for s in samples], axis=0) for k in samples[0]}


def prefetch_to_device(iterator, device: Optional[Union[str, torch.device]] = None,
                       size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """numpy batches -> tensors on ``device`` (``cuda`` by default).

    A background thread turns up to ``size`` batches into (pinned, on a
    card) host tensors; the consumer side issues the copy of batch i+1
    before it yields batch i.
    """
    device = resolve_device(device)
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if pin:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not put(host):
                    return
        except BaseException as e:  # handed to the consumer, which re-raises it
            put(e)
            return
        put(end)

    def upload(host):
        return {k: v.to(device, non_blocking=True) for k, v in host.items()}

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        ready = None
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is end:
                break
            nxt = upload(item)
            if ready is not None:
                yield ready
            ready = nxt
        if ready is not None:
            yield ready
    finally:
        stop.set()
        thread.join(timeout=10)
