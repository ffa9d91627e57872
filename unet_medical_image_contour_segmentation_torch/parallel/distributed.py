"""Process bootstrap and per-rank input slicing, the port's counterpart of
the JAX package's ``parallel/distributed.py``.

In the JAX package one process drives every device of its host and
``jax.distributed`` joins the hosts; here every rank is one process with one
device, joined by a ``torch.distributed`` process group: NCCL between
cards, gloo on the CPU.  A multi-GPU host therefore runs one process per
card, either spawned by ``train_model`` (``num_devices=N``) or launched by
the caller with :func:`initialize` (the train CLI's ``--distributed``).

JAX's ``assemble_global_batch`` has no counterpart: each rank keeps the rows
it fed, and the collectives of the step (``ops/collectives.py``) reduce
over them where JAX assembles a global array.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["initialize", "is_multi_host", "local_batch_slice", "local_replica", "rank_device"]

log = logging.getLogger(__name__)

# how long a rank waits in a collective for the others before it fails
TIMEOUT = timedelta(minutes=10)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None) -> None:
    """Join this process to the default process group as rank ``process_id``
    of ``num_processes``.

    ``coordinator_address`` is ``host:port`` of rank 0 (a TCP rendezvous) or
    a ``torch.distributed`` init URL (``tcp://``, ``file://``); with neither
    it nor ``num_processes``, the launcher's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as torchrun sets them)
    is read, and without those this stays a single process.  The backend is
    NCCL for a CUDA ``device`` (the default) and gloo for the CPU.  A no-op
    when a group is already initialised; a failed rendezvous raises.
    """
    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    if coordinator_address is None and num_processes is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            log.debug("no coordinator and no launcher environment: single process")
            return
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("multi-host training needs coordinator_address, num_processes "
                             "and process_id together")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id, timeout=TIMEOUT)
    log.info("torch.distributed (%s): rank %d of %d", backend, dist.get_rank(),
             dist.get_world_size())


def is_multi_host() -> bool:
    """True when this process is one rank of several."""
    return dist.is_initialized() and dist.get_world_size() > 1


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of ``rank`` on its host: ``cuda:{LOCAL_RANK}`` (the
    launcher's, else ``rank`` modulo the host's cards) for a CUDA
    ``device``, the CPU for the CPU."""
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous rows of a globally ordered batch: rank p holds
    rows [p * per_rank, (p + 1) * per_rank)."""
    ranks = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    per_rank = global_batch // ranks
    return slice(rank * per_rank, (rank + 1) * per_rank)


def local_replica(tree):
    """The identity: each rank already holds a full replica of the
    parameters, where JAX's replicated arrays span other hosts' devices."""
    return tree
