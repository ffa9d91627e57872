"""Data and spatial parallelism over ``torch.distributed``: process
bootstrap, the cross-replica train and eval steps, and the row-sharded
forward, train and eval steps with their (data, spatial) layouts (the JAX
package's ``parallel/``)."""

from .data_parallel import (
    batch_slice,
    make_data_group,
    make_parallel_eval_step,
    make_parallel_train_step,
    replicate,
)
from .distributed import initialize as distributed_initialize
from .distributed import is_multi_host, local_batch_slice
from .spatial import (
    SpatialMesh,
    make_dp_spatial_mesh,
    make_spatial_eval_step,
    make_spatial_forward,
    make_spatial_mesh,
    make_spatial_train_step,
    shard_batch,
    tiled_inference,
)

__all__ = [
    "batch_slice",
    "make_data_group",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "replicate",
    "distributed_initialize",
    "is_multi_host",
    "local_batch_slice",
    "SpatialMesh",
    "make_dp_spatial_mesh",
    "make_spatial_eval_step",
    "make_spatial_forward",
    "make_spatial_mesh",
    "make_spatial_train_step",
    "shard_batch",
    "tiled_inference",
]
