"""Spatial parallelism over ``torch.distributed``: row-sharded forwards and
train steps, and tiled inference, the port's counterpart of the JAX
package's ``parallel/spatial.py``.

JAX jits the single-device step with the images' H axis sharded over a mesh
axis, and XLA's partitioner inserts the halo exchanges and the collectives.
Torch has no partitioner, so the port writes them by hand:

* the layout: ``dp * sp`` ranks, one process and one device each; rank r
  holds band ``r % sp`` of the rows of the images of data index ``r // sp``
  (JAX's ``reshape(dp, sp)`` grid).  :func:`make_dp_spatial_mesh` builds
  its groups: every rank of the layout, the spatial group of each data
  index, and the data group of each band;
* the forward: every padded conv (the 3x3 convs of stride 1 and 2,
  unet_sa's 7x7 gate), the bilinear upsample and YOLOv8-seg's 5x5 SPPF
  pools (a halo of -inf) read a halo of the neighbouring bands' rows
  (``ops/halo.py``, ``ops/nn.py:conv2d``, ``ops/resize.py``,
  ``models/yolov8_seg.py:maxpool5_same``); the 3x3 stride-1 convs still
  run the hand kernel, at (B, h + 2, W, Cin).  The 2x2 max pools, the k2
  s2 transpose convs, the nearest upsamples and the 1x1 convs are
  row-local, given bands whose height is a multiple of ``hw_divisor`` (H
  divisible by ``sp * hw_divisor``);
* the reductions: BN statistics, CE/BCE and Dice over every rank of the
  layout (equal bands keep ``pmean`` exact); the boundary term and the cc
  penalty, which read whole images, over gathered bands and the data group
  alone (``losses/compound.py``);
* the gradients: averaged over every rank of the layout before the clip,
  as in ``parallel/data_parallel.py``, and for the same reason.  Each
  collective of the step is linear, and its backward is its adjoint: the
  SUM all-reduce's backward sums the ranks' gradients, the halo exchange's
  sends each halo row's gradient back to the rank that owns the row.  So
  each rank's backward is the gradient, with respect to its own copy of
  the parameters, of the sum of every rank's copy of the loss: the world
  size times its share of the gradient of the global loss, and the
  average over the ranks is the single-device gradient on the global
  batch.

The UNet family (``unet``, ``unet_t``, ``unet_s``, ``unet_sa``, bilinear or
transpose-conv ups, remat), UNet++ and YOLOv8-seg row-shard.  One departure
from JAX: SPPF's pools read 2 rows of each neighbour at stride 32, so
YOLOv8-seg needs bands of at least 2 rows there (H >= ``sp * 64``) and
raises ValueError below that, where GSPMD also takes bands of 1 row.

:func:`tiled_inference` is JAX's single-device library form of tiled
serving, on the Predictor's device grid (``engine/predict.py:_tile_grid``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..engine.evaluate import eval_forward
from ..engine.optim import RMSpropConfig
from ..engine.train import TrainStep
from ..losses.compound import LossConfig
from ..ops.halo import Shard, all_reduce_bits

__all__ = [
    "SpatialMesh",
    "make_spatial_mesh",
    "make_dp_spatial_mesh",
    "check_model",
    "data_rows",
    "band_rows",
    "shard_batch",
    "make_spatial_forward",
    "make_spatial_eval_step",
    "make_spatial_train_step",
    "tiled_inference",
]


@dataclasses.dataclass(frozen=True)
class SpatialMesh:
    """This rank's place in a (``dp``, ``sp``) layout: ``group`` holds every
    rank of the layout (BN, the pixel-mean losses, the gradient average),
    ``shard`` this rank's band and its spatial and data groups."""

    group: dist.ProcessGroup
    shard: Shard
    dp: int
    sp: int

    @property
    def data_index(self) -> int:
        return dist.get_rank(self.group) // self.sp


def _group(ranks: List[int]) -> dist.ProcessGroup:
    return dist.group.WORLD if len(ranks) == dist.get_world_size() else dist.new_group(ranks)


def make_dp_spatial_mesh(dp: int, sp: int) -> Optional[SpatialMesh]:
    """The 2-D (data, spatial) layout of the first ``dp * sp`` ranks of the
    default group: batch rows over ``dp``, image rows over ``sp``.  Every
    rank of the default group must call it (it creates the groups, in one
    order on every rank); a rank outside the layout gets None."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize first, or "
                           "train with train_model(spatial_shards=N), which spawns the ranks")
    world = dist.get_world_size()
    if dp < 1 or sp < 1 or dp * sp > world:
        raise ValueError(f"need {dp * sp} ranks, have {world}")
    group = _group(list(range(dp * sp)))
    spatial = [_group([d * sp + s for s in range(sp)]) for d in range(dp)]
    data = [_group([d * sp + s for d in range(dp)]) for s in range(sp)] if dp > 1 else None
    rank = dist.get_rank()
    if rank >= dp * sp:
        return None
    d, s = divmod(rank, sp)
    return SpatialMesh(group, Shard(spatial[d], s, sp, data[s] if data else None), dp, sp)


def make_spatial_mesh(n_devices: Optional[int] = None) -> Optional[SpatialMesh]:
    """The 1-D spatial layout of the first ``n_devices`` ranks (all of them
    when None): every rank holds a band of the rows of the whole batch."""
    return make_dp_spatial_mesh(1, dist.get_world_size() if n_devices is None else n_devices)


def check_model(model: nn.Module) -> None:
    """Raise NotImplementedError for a model that does not row-shard."""
    from ..models.unet import UNet
    from ..models.unet_nested import UNetPlusPlus
    from ..models.yolov8_seg import YOLOv8Seg

    if not isinstance(model, (UNet, UNetPlusPlus, YOLOv8Seg)):
        raise NotImplementedError(
            f"spatial sharding is not ported for {getattr(model, 'name', type(model).__name__)}"
            f": the UNet family, UNet++ and YOLOv8-seg train and serve row-sharded")


def data_rows(mesh: SpatialMesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` images."""
    if batch % mesh.dp:
        raise ValueError(f"batch_size {batch} must be divisible by the data-parallel degree "
                         f"{mesh.dp} (= num_devices/spatial_shards)")
    per = batch // mesh.dp
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def band_rows(mesh: SpatialMesh, height: int) -> slice:
    """This rank's band of the rows of images of ``height`` rows."""
    if height % mesh.sp:
        raise ValueError(f"H {height} must be divisible by spatial_shards {mesh.sp}")
    per = height // mesh.sp
    return slice(mesh.shard.index * per, (mesh.shard.index + 1) * per)


def shard_batch(batch: Dict, mesh: SpatialMesh) -> Dict:
    """This rank's block of a global batch of (B, H, ...) arrays or tensors:
    its images' rows, its band of their rows."""
    b, h = next(iter(batch.values())).shape[:2]
    block = (data_rows(mesh, b), band_rows(mesh, h))
    return {k: v[block] for k, v in batch.items()}


def _gathered(mesh: SpatialMesh, image: torch.Tensor,
              fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``fn`` of this rank's block of ``image``, the blocks of every rank
    gathered into the whole batch by one SUM all-reduce of a zero-filled
    buffer (``ops/halo.py:all_reduce_bits``)."""
    block = (data_rows(mesh, image.shape[0]), band_rows(mesh, image.shape[1]))
    local = fn(image[block])
    out = local.new_zeros((image.shape[0], image.shape[1], *local.shape[2:]))
    out[block] = local
    return all_reduce_bits(out, mesh.group)


def make_spatial_forward(model: nn.Module, mesh: SpatialMesh
                         ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``forward(image) -> logits``: the eval-mode logits (B, H, W, C) of a
    global batch (B, H, W[, C]) given whole to every rank, each rank
    computing its block (JAX's ``make_spatial_forward``).  The ranks' models
    must hold the same weights (``parallel.replicate``)."""
    check_model(model)

    def forward(image: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                return _gathered(mesh, image, lambda x: model(x, shard=mesh.shard))
        finally:
            model.train(was_training)

    return forward


def make_spatial_eval_step(model: nn.Module, mesh: SpatialMesh
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """``step(image) -> (B, H, W) int32 classes`` of a global batch given
    whole to every rank (B a multiple of ``dp``), each rank running the eval
    forward (:func:`engine.evaluate.eval_forward`) on its block: the
    spatial ``make_parallel_eval_step``, for ``evaluate(eval_step=...,
    batch_pad=mesh.dp)``."""
    check_model(model)
    return lambda image: _gathered(mesh, image, lambda x: eval_forward(model, x, mesh.shard))


def make_spatial_train_step(model: nn.Module, loss_cfg: LossConfig, opt_cfg: RMSpropConfig,
                            mesh: SpatialMesh, clipping: float = 1.0) -> TrainStep:
    """The train step of ``mesh``: ``step(batch, lr)`` with ``batch`` this
    rank's block on its device (:func:`shard_batch`), numerically the
    single-device step on the global batch (see the module docstring; JAX's
    ``make_spatial_train_step``).  Start the ranks equal with
    ``parallel.replicate(model, step.optimizer, mesh.group)``."""
    check_model(model)
    return TrainStep(model, loss_cfg, opt_cfg, clipping, group=mesh.group, shard=mesh.shard)


def tiled_inference(model: nn.Module, image: torch.Tensor, *, tile: int = 512,
                    halo: int = 96, tile_batch: int = 8) -> torch.Tensor:
    """(N, H, W) int32 classes of an NHWC image on the model's device through
    overlapping tiles of ``tile`` pixels with a ``halo`` margin, ``tile_batch``
    windows a forward, on one device: the Predictor's device grid
    (``engine/predict.py:_Serving._tile_grid``) around the model's own
    eval forward.  Exact where ``halo`` covers the model's half receptive
    field."""
    from ..engine.predict import _Serving

    class _Tiled(_Serving):
        def _logits(self, x: torch.Tensor, r: int = 0) -> torch.Tensor:
            return model(x)

    device = next(model.parameters()).device
    serving = _Tiled(device, 1, tile, halo, 0)
    serving.tile_batch = tile_batch
    was_training = model.training
    model.eval()
    try:
        return serving._tile_grid(image, tile, halo).int()
    finally:
        model.train(was_training)
