"""Batched, multi-worker input pipeline and its prefetch to the card.

The port's counterpart of the JAX package's ``data/loader.py``: a thread
pool decodes and augments samples (PIL and numpy release the GIL) and
batches are stacked channel-last.  :func:`prefetch_to_device` keeps up to
``size`` batches in flight ahead of the consumer, as JAX's ``device_put``
thread does: a background thread pins each batch and issues its
host-to-card copy on a side stream of the card, so that on the card the
copy of a later batch runs beside the step that reads an earlier one.
"""

from __future__ import annotations

import collections
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
    """numpy batches -> tensors on ``device`` (``cuda`` by default), in order,
    each equal to its numpy batch.

    A background thread turns batches into tensors, at most ``size`` ahead
    of the one the consumer holds.  On a card it pins each batch, copies it
    on one side stream of ``device`` and records an event after the copies;
    before a batch is yielded, the consumer's current stream waits on its
    event, and each tensor is marked as used by that stream
    (``record_stream``), so that the caching allocator gives its memory to
    no later copy while the consumer's work on it is still queued.  Each
    pinned host batch is held until its copy has finished.  On the CPU the
    batches are the numpy arrays' tensors.  An exception of ``iterator``
    is raised to the consumer in the batch's place.
    """
    if size < 1:
        raise ValueError(f"size must be at least 1, got {size}")
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue()
    slots = threading.Semaphore(size)  # batches handed over, not yet taken
    end = object()
    stop = threading.Event()

    def wait_slot() -> bool:
        while not stop.is_set():
            if slots.acquire(timeout=0.1):
                return True
        return False

    def producer():
        copying = collections.deque()  # (event, pinned batch) until its copy ends
        try:
            if cuda:
                torch.cuda.set_device(device)
                side = torch.cuda.Stream(device)
            for batch in iterator:
                host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
                if cuda:
                    host = {k: v.pin_memory() for k, v in host.items()}
                if not wait_slot():
                    return
                if not cuda:
                    q.put((host, None))
                    continue
                with torch.cuda.stream(side):
                    out = {k: v.to(device, non_blocking=True) for k, v in host.items()}
                    event = torch.cuda.Event()
                    event.record(side)
                q.put((out, event))
                copying.append((event, host))
                while copying and copying[0][0].query():
                    copying.popleft()
        except BaseException as e:  # handed to the consumer, which re-raises it
            q.put(e)
            return
        finally:
            for event, _ in copying:
                event.synchronize()
        q.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            if item is end:
                break
            slots.release()
            batch, event = item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in batch.values():
                    t.record_stream(stream)
            yield batch
    finally:
        stop.set()
        thread.join(timeout=10)
