"""Data parallelism over ``torch.distributed``: process bootstrap, the
cross-replica train and eval steps (the JAX package's ``parallel/``; its
spatial parallelism is not ported)."""

from .data_parallel import (
    batch_slice,
    make_data_group,
    make_parallel_eval_step,
    make_parallel_train_step,
    replicate,
)
from .distributed import initialize as distributed_initialize
from .distributed import is_multi_host, local_batch_slice

__all__ = [
    "batch_slice",
    "make_data_group",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "replicate",
    "distributed_initialize",
    "is_multi_host",
    "local_batch_slice",
]
