"""Training engine: one train step and the reference's training loop.

The port of the JAX package's ``engine/train.py``.  A step is the forward in
``train()`` mode (bf16 compute with f32 master weights when the model's
``compute_dtype`` is bf16, no loss scaling), the compound loss in f32,
``backward`` (the 3x3 kernel's dx runs the hand kernel again), the
global-norm clip and torch's RMSprop at the given lr.  Where JAX returns a
new state, the port updates the model and the optimizer in place.

``train_model`` keeps the loop's behaviour:

* the NaN guard, checked ``nan_check_every`` steps behind so that it never
  stalls the card;
* validation once per epoch, then the ``scheduler_quirk`` LR step (the
  reference steps the schedule with the Dice score);
* checkpoints every ``checkpoint_every`` epochs past ``checkpoint_after_frac``
  of the run, and the final ``model_epoch{N}.npz``, with the optimizer state.
  The periodic ones are written by ``save_checkpoint_async`` on one worker
  thread per run, in epoch order, so the loop does not wait on the disk (as
  JAX's loop); the loop waits for them before the final save and before it
  returns or raises, and a failed write raises from ``train_model``.

* with ``cc_loss`` (binary models only), the connected-component penalty
  scored on the host on that same delayed fetch and added to the logged
  loss value, never to the gradient (JAX's ``check_nan``); the fetch window
  is then clamped to 8 steps, since each queued step holds a (B, H, W)
  probability map on the card.

The whole UNet family trains (``unet``, ``unet_t``, ``unet_s``, ``unet_sa``,
bilinear or ConvTranspose ups, ``remat``), and UNet++ (``unet_pp``,
``unet_pp_s``, ``remat`` per node) and YOLOv8-seg (``yolov8_seg_s``), with
the binary or multiclass criterion.  tqdm, PIL and cv2 are imported only on
the paths that use them (progress bars, prediction dumps, post-processed
Dice, the connected-component penalty).

Data parallelism (``num_devices`` > 1; ``parallel/data_parallel.py``): each
rank is a process with one device and its rows of every global batch of
``batch_size``.  ``train_model`` spawns the ranks itself (one per card,
``cuda:0..N-1``, or N CPU processes for ``device="cpu"``; a ``file://``
rendezvous in a fresh temporary directory, NCCL or gloo) and returns rank
0's final state; when the caller has already joined a process group
(``parallel.distributed.initialize``: the train CLI's ``--distributed``, or
torchrun), this process is one rank and trains as such.  Only rank 0
logs metrics, writes prediction PNGs and saves checkpoints; validation
shards each batch over the ranks.

Spatial parallelism (``spatial_shards`` > 1; ``parallel/spatial.py``):
``num_devices`` ranks (all the host's cards by default; ``spatial_shards``
CPU processes for ``device="cpu"``) in a (dp, sp) layout of ``dp =
num_devices / spatial_shards``: each rank takes its dp-th of every global
batch and its band of their rows, validation gathers the classes of every
block, and rank 0 saves checkpoints.  Single-host only, as in JAX: a process
that has already joined a group of several raises ``NotImplementedError``.
Every model trains row-sharded (YOLOv8-seg with H >= spatial_shards * 64).
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import TrainConfig
from ..device import resolve_device
from ..losses.compound import LossConfig, compute_loss
from ..models.torch_compat import state_dict_from_jax
from .checkpoint import save_checkpoint, save_checkpoint_async
from .evaluate import evaluate
from .optim import (
    RMSpropConfig,
    clip_by_global_norm,
    load_opt_state,
    make_optimizer,
    warm_restarts_lr,
)

log = logging.getLogger(__name__)

__all__ = ["TrainStep", "make_train_step", "train_model"]


class TrainStep:
    """``step(batch, lr) -> metrics``: one optimisation step of ``model``.

    ``batch`` holds ``image`` (B, H, W[, C]) float and ``mask`` (B, H, W)
    integer tensors on the model's device.  The metrics (``ce``, ``dice``,
    ``loss``, ``grad_norm``, ``lr``; ``boundary`` for the binary loss) are 0-d
    f32 tensors on that device, and ``cc_probs`` a (B, H, W) map when the
    loss config emits it; nothing in the step waits for the card.  ``step``
    counts the steps taken.

    ``group`` (a ``torch.distributed`` process group; None is one device):
    ``batch`` is this rank's rows of a global batch, BN and the loss reduce
    over the group, and the gradients are averaged over it before the clip
    (``parallel/data_parallel.py``), so every rank takes the single-device
    step on the global batch.  With a ``shard`` as well (``ops/halo.py``,
    ``parallel/spatial.py``), ``batch`` is this rank's band of rows of its
    images, and the forward and the loss read the other bands through the
    shard's spatial group.
    """

    def __init__(self, model: nn.Module, loss_cfg: LossConfig, opt_cfg: RMSpropConfig,
                 clipping: float = 1.0, group=None, shard=None):
        self.model = model
        self.loss_cfg = loss_cfg
        self.clipping = clipping
        self.group = group
        self.shard = shard
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.params, opt_cfg)
        self.step = 0

    def __call__(self, batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        self.model.train()
        kw = {} if self.shard is None else {"shard": self.shard}
        logits = self.model(batch["image"], group=self.group, **kw)
        loss, metrics = compute_loss(logits, batch["mask"], self.loss_cfg, self.group,
                                     self.shard)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in self.params]
        if self.group is not None:
            # JAX's pmean of the gradients: one all-reduce of them all, flattened
            flat = torch._utils._flatten_dense_tensors(grads)
            dist.all_reduce(flat, group=self.group)
            flat /= dist.get_world_size(self.group)
            torch._foreach_copy_(grads, torch._utils._unflatten_dense_tensors(flat, grads))
        grad_norm = clip_by_global_norm(grads, self.clipping)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        metrics["lr"] = torch.full((), lr, dtype=torch.float32, device=loss.device)
        return metrics


def make_train_step(model: nn.Module, loss_cfg: LossConfig, opt_cfg: RMSpropConfig,
                    clipping: float = 1.0) -> TrainStep:
    """The step of JAX's ``make_train_step``, bound to ``model`` and a fresh
    RMSprop over its parameters."""
    return TrainStep(model, loss_cfg, opt_cfg, clipping)


def _spatial_devices(cfg: TrainConfig, device: torch.device) -> int:
    """The ranks of a row-sharded run (JAX ``engine/train.py``'s checks and
    texts): ``num_devices``, by default every card of the host, or
    ``spatial_shards`` CPU processes."""
    sp = cfg.spatial_shards
    if dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError("spatial_shards > 1 is single-host only; use data "
                                  "parallelism across hosts")
    n_dev = cfg.num_devices or (torch.cuda.device_count() if device.type == "cuda" else sp)
    if sp > n_dev:
        raise ValueError(f"spatial_shards {sp} exceeds the {n_dev} available devices")
    if n_dev % sp:
        raise ValueError(f"num_devices {n_dev} must be divisible by spatial_shards {sp}")
    dp = n_dev // sp
    if dp > 1 and cfg.batch_size % dp:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by the "
                         f"data-parallel degree {dp} (= num_devices/spatial_shards)")
    return n_dev


def train_model(cfg: TrainConfig, model: Optional[nn.Module] = None, train_set=None,
                val_set=None, state: Optional[dict] = None, mask_values=None,
                metric_backends=None, device: Optional[Union[str, torch.device]] = None
                ) -> TrainStep:
    """The full training loop; returns the final :class:`TrainStep` (its
    ``model``, ``optimizer`` and ``step``).

    ``train_set``/``val_set`` follow the BasicDataset protocol (``len`` and
    ``[i] -> {"image", "mask"}`` numpy); when omitted they are built from
    ``cfg.data_root`` (imgs/train, masks/train, imgs/val, masks/val).
    ``state`` resumes a run: a dict with ``params``, ``bn_state``,
    ``opt_state`` (or None) and ``step`` in the JAX layout, as
    ``load_checkpoint`` returns for a checkpoint of either package.
    ``device`` defaults to ``cuda``.

    ``cfg.num_devices`` (None: one device) > 1 trains data-parallel over
    that many ranks with ``cfg.batch_size`` the global batch (see the module
    docstring); it raises where the host has fewer cards.  Spawned ranks
    receive the model, the datasets and ``metric_backends`` pickled, and the
    returned step holds rank 0's final state on ``device``.  In a process
    that has already joined a group, ``num_devices`` is the group's size
    (None takes it).  ``cfg.spatial_shards`` > 1 trains row-sharded (see the
    module docstring), with JAX's rules and messages.
    """
    from ..models.unet import get_model

    if cfg.cc_loss and cfg.classes != 1:
        # the penalty is part of the binary loss only (the reference ships it
        # commented out inside its n_classes == 1 branch)
        log.warning("--cc-loss has no effect with classes=%d: the connected-component "
                    "penalty is part of the binary (classes=1) loss only", cfg.classes)
    device = resolve_device(device)
    sp = cfg.spatial_shards
    if sp > 1:
        n_dev = _spatial_devices(cfg, device)
    elif dist.is_initialized():
        world = dist.get_world_size()
        n_dev = cfg.num_devices or world
        if n_dev != world:
            raise ValueError(f"num_devices {n_dev} must equal the {world} ranks of the "
                             f"process group (one device per process)")
    else:
        n_dev = cfg.num_devices or 1
    if n_dev > 1 and sp == 1 and cfg.batch_size % n_dev:
        raise ValueError(f"batch_size {cfg.batch_size} must be divisible by num_devices "
                         f"{n_dev}")
    if n_dev > 1 and not dist.is_initialized() and device.type == "cuda" \
            and n_dev > torch.cuda.device_count():
        raise ValueError(f"num_devices {n_dev} exceeds the {torch.cuda.device_count()} "
                         f"CUDA devices of this host")
    if model is None:
        model = get_model(cfg.model, n_channels=cfg.n_channels, n_classes=cfg.classes,
                          bilinear=cfg.bilinear, remat=cfg.remat,
                          compute_dtype=torch.bfloat16 if cfg.amp else None)
    if sp > 1:
        from ..parallel.spatial import check_model

        check_model(model)
    if train_set is None:
        from ..data.dataset import BasicDataset

        root = Path(cfg.data_root)
        dc = Path(cfg.disk_cache_dir) if cfg.disk_cache_dir else None
        kw = dict(augment=cfg.augment, cache_bytes=cfg.sample_cache_bytes)
        train_set = BasicDataset(root / "imgs/train", root / "masks/train", cfg.scale,
                                 disk_cache_dir=dc / "train" if dc else None, **kw)
        val_set = BasicDataset(root / "imgs/val", root / "masks/val", cfg.scale,
                               disk_cache_dir=dc / "val" if dc else None, **kw)
    if mask_values is None:
        mask_values = (list(getattr(train_set, "mask_values", []))
                       + list(getattr(val_set, "mask_values", [])))
    if state is not None:
        model.load_state_dict(state_dict_from_jax(state["params"], state["bn_state"]))
    run = (cfg, model, train_set, val_set, state, mask_values, metric_backends)
    if dist.is_initialized() and sp == 1:
        from ..parallel.distributed import rank_device

        device = rank_device(device, dist.get_rank())
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return _train(*run, device, dist.group.WORLD if n_dev > 1 else None)
    if n_dev > 1:
        return _spawn_ranks(run, n_dev, device)
    return _train(*run, device, None)


def _spawn_ranks(run: tuple, n_dev: int, device: torch.device) -> TrainStep:
    """Train on ``n_dev`` spawned ranks and load rank 0's final state into the
    caller's model on ``device``.  A rank that raises stops the others, and
    its traceback comes back in a RuntimeError.

    The ranks receive ``run`` as pickled bytes, so that each holds its own
    copy of the model: torch's process pickler would hand them one
    shared-memory storage, which every rank's optimizer would then update."""
    import pickle

    import torch.multiprocessing as mp

    cfg, model = run[0], run[1]
    model.cpu()
    payload = pickle.dumps(run)
    with tempfile.TemporaryDirectory(prefix="umics-ranks-") as tmp:
        rendezvous = f"file://{os.path.join(tmp, 'rendezvous')}"
        result = os.path.join(tmp, "rank0.pt")
        try:
            mp.start_processes(_rank_main, args=(n_dev, rendezvous, payload, device.type,
                                                 torch.get_num_threads(), result),
                               nprocs=n_dev, start_method="spawn")
        except mp.ProcessRaisedException as e:
            raise RuntimeError(f"a rank failed:\n{e}") from None
        final = torch.load(result, map_location="cpu", weights_only=True)
    model.load_state_dict(final["model"])
    model.to(device)
    step_fn = TrainStep(model, _loss_config(cfg, model), _opt_config(cfg),
                        cfg.gradient_clipping)
    step_fn.optimizer.load_state_dict(final["optimizer"])
    step_fn.step = final["step"]
    return step_fn


def _rank_main(rank: int, n_dev: int, rendezvous: str, payload: bytes, device_type: str,
               threads: int, result: str) -> None:
    """One spawned rank: join the group, train ``pickle.loads(payload)``'s
    run, and (rank 0) write the final state to ``result``."""
    import pickle

    run = pickle.loads(payload)
    torch.set_num_threads(threads)
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    from ..parallel.distributed import TIMEOUT

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=rendezvous, world_size=n_dev, rank=rank,
                            timeout=TIMEOUT)
    try:
        step_fn = _train(*run, device, dist.group.WORLD)
        if rank == 0:
            torch.save({"model": step_fn.model.state_dict(),
                        "optimizer": step_fn.optimizer.state_dict(), "step": step_fn.step},
                       result)
    finally:
        dist.destroy_process_group()


def _loss_config(cfg: TrainConfig, model: nn.Module) -> LossConfig:
    return LossConfig(n_classes=model.n_classes, boundary_weight=cfg.boundary_weight,
                      boundary_edge_width=cfg.boundary_edge_width,
                      boundary_edge_weight=cfg.boundary_edge_weight,
                      connected_component=cfg.cc_loss, cc_emit_probs=True)


def _opt_config(cfg: TrainConfig) -> RMSpropConfig:
    return RMSpropConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                         momentum=cfg.momentum)


def _train(cfg: TrainConfig, model: nn.Module, train_set, val_set, state: Optional[dict],
           mask_values, metric_backends, device: torch.device, group) -> TrainStep:
    """The loop of one process: the only one (``group`` None), or one rank
    of ``group``."""
    from ..data.loader import DataLoader, prefetch_to_device
    from ..parallel.data_parallel import make_parallel_eval_step, replicate
    from ..utils.metrics import MetricLogger

    lead = group is None or dist.get_rank(group) == 0
    mesh, shard, cc_group = None, None, group
    if group is None:
        process_slice, val_step, val_pad, replicas = None, None, 1, 1
    elif cfg.spatial_shards > 1:
        from ..parallel import spatial

        mesh = spatial.make_dp_spatial_mesh(dist.get_world_size(group) // cfg.spatial_shards,
                                            cfg.spatial_shards)
        group, shard, cc_group = mesh.group, mesh.shard, mesh.shard.data_group
        process_slice = spatial.data_rows(mesh, cfg.batch_size)
        val_step = spatial.make_spatial_eval_step(model, mesh)
        val_pad = replicas = mesh.dp
    else:
        from ..parallel.distributed import local_batch_slice

        process_slice = local_batch_slice(cfg.batch_size)
        val_step = make_parallel_eval_step(model, group)
        val_pad = replicas = dist.get_world_size(group)
    # every train batch full when data-parallel: each rank needs its rows
    train_loader = DataLoader(train_set, cfg.batch_size, shuffle=True,
                              num_workers=cfg.num_workers, seed=cfg.seed,
                              drop_last=group is not None, process_slice=process_slice)
    val_loader = DataLoader(val_set, cfg.batch_size, shuffle=False, drop_last=True,
                            num_workers=cfg.num_workers)
    n_train = len(train_set)
    log.info("Starting training: epochs=%d batch=%d lr=%g scale=%g amp(bf16)=%s model=%s "
             "device=%s ranks=%d", cfg.epochs, cfg.batch_size, cfg.learning_rate, cfg.scale,
             cfg.amp, model.name, device, 1 if group is None else dist.get_world_size(group))

    loss_cfg = _loss_config(cfg, model)
    model.to(device)
    step_fn = TrainStep(model, loss_cfg, _opt_config(cfg), cfg.gradient_clipping, group, shard)
    if state is not None:
        step_fn.step = int(state["step"])
        if state.get("opt_state") is not None:
            load_opt_state(model, step_fn.optimizer, state["opt_state"], step_fn.step)
    if group is not None:
        replicate(model, step_fn.optimizer, group)

    mlog = MetricLogger(cfg.metrics_path if lead else None,
                        backends=metric_backends if lead else None)
    lr = cfg.learning_rate  # the scheduler sets the base lr at construction
    nan_check_every = max(1, cfg.nan_check_every)
    if cfg.cc_loss and nan_check_every > 8:
        log.warning("nan_check_every=%d clamped to 8: --cc-loss queues a full probability "
                    "map per pending step", nan_check_every)
        nan_check_every = 8
    elif nan_check_every > 256:
        log.warning("nan_check_every=%d is very large: the NaN guard will lag training by "
                    "as many steps", nan_check_every)
    pending = []  # (global step, device metrics), fetched nan_check_every steps behind

    def drain_pending():
        """Fetch and check every queued step in one copy; -> (sum, last loss).
        A step's ``cc_probs`` map comes to the host beside it, and its
        connected-component penalty joins the logged loss: the mean of the
        ranks' penalties when data-parallel (each scores its own images, and
        every rank's batch is the same size; a row-sharded step hands every
        rank of a spatial group the same whole images, so the mean is over
        the data group)."""
        if not pending:
            return 0.0, None
        keys = [k for k in pending[0][1] if k != "cc_probs"]
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, m in pending]).cpu().numpy()
        cc = None
        if "cc_probs" in pending[0][1]:
            from ..losses.connected_component import connected_component_loss

            cc = [connected_component_loss(
                m["cc_probs"].cpu().numpy(), edge_distance=loss_cfg.cc_edge_distance,
                min_area=loss_cfg.cc_min_area, penalty_weight=loss_cfg.cc_penalty_weight)
                for _, m in pending]
            if cc_group is not None:
                t = torch.tensor(cc, dtype=torch.float64, device=device)
                dist.all_reduce(t, group=cc_group)
                cc = (t / dist.get_world_size(cc_group)).tolist()
        total = last = 0.0
        for i, ((step_idx, _), row) in enumerate(zip(pending, host)):
            metrics = dict(zip(keys, row.tolist()))
            if cc is not None:
                metrics["cc"] = cc[i]
                metrics["loss"] += metrics["cc"]
            last = metrics["loss"]
            if not np.isfinite(last):
                raise RuntimeError("Fatal: NaN loss detected!")
            mlog.log("train_step", step=step_idx, **metrics)
            total += last
        pending.clear()
        return total, last

    # one worker: the periodic saves land in epoch order (latest_checkpoint
    # goes by modification time)
    saver = ThreadPoolExecutor(max_workers=1, thread_name_prefix="umics-checkpoint")
    saves = []
    try:
        for epoch in range(1, cfg.epochs + 1):
            epoch_loss = 0.0
            epoch_pred_dir = None
            if cfg.save_val_predictions and lead:
                epoch_pred_dir = Path(cfg.predictions_dir) / f"epoch_{epoch}"
                epoch_pred_dir.mkdir(parents=True, exist_ok=True)

            pbar = None
            if cfg.progress and lead:
                from tqdm import tqdm

                # disable=None hides the bar on a non-TTY stderr
                pbar = tqdm(total=n_train, desc=f"Epoch {epoch}/{cfg.epochs}", unit="img",
                            disable=None)
            t0 = time.perf_counter()
            n_seen = 0
            batches = iter(train_loader)
            if mesh is not None:  # this rank's band of its images' rows
                batches = ({k: v[:, spatial.band_rows(mesh, v.shape[1])] for k, v in b.items()}
                           for b in batches)
            for batch in prefetch_to_device(batches, device):
                image = batch["image"]
                n_ch = 1 if image.dim() == 3 else image.shape[-1]
                if n_ch != model.n_channels:
                    raise ValueError(f"Network has been defined with {model.n_channels} input "
                                     f"channels, but loaded images have {n_ch} channels.")
                metrics = step_fn(batch, lr)
                n_seen += image.shape[0] * replicas
                if pbar is not None:
                    pbar.update(image.shape[0])
                # drain before queueing the step just launched, so the fetch
                # only waits on steps already queued ahead of it
                if len(pending) >= nan_check_every:
                    window_loss, last_loss = drain_pending()
                    epoch_loss += window_loss
                    if pbar is not None:
                        pbar.set_postfix(**{"loss (batch)": f"{last_loss:.4f}"})
                pending.append((step_fn.step, metrics))
                if cfg.log_every and step_fn.step % cfg.log_every == 0:
                    log.info("epoch %d step %d loss(total)=%.5f", epoch, step_fn.step,
                             epoch_loss)
            epoch_loss += drain_pending()[0]
            if pbar is not None:
                pbar.close()
            dt = time.perf_counter() - t0
            log.info("epoch %d done: loss(total)=%.5f %.2f slices/s", epoch, epoch_loss,
                     n_seen / max(dt, 1e-9))

            val_score, val_post, min_val = evaluate(
                model, val_loader, device=device,
                epoch_pred_dir=str(epoch_pred_dir) if epoch_pred_dir else None,
                postprocess=cfg.val_postprocess, progress=cfg.progress and lead,
                eval_step=val_step, batch_pad=val_pad)
            log.info("Validation Dice score: %s", val_score)
            log.info("Validation Postprocessed Dice score: %s", val_post)
            log.info("Validation Min Dice score: %s", min_val)
            mlog.log("validation", epoch=epoch, dice=val_score, dice_postprocessed=val_post,
                     min_dice=min_val, lr=lr, epoch_loss=epoch_loss,
                     slices_per_sec=n_seen / max(dt, 1e-9))

            # the faithful quirk passes the Dice score as the epoch
            sched_t = val_score if cfg.scheduler_quirk else float(epoch)
            lr = warm_restarts_lr(sched_t, cfg.learning_rate, T_0=cfg.sched_t0,
                                  T_mult=cfg.sched_t_mult, eta_min=cfg.sched_eta_min)

            if (cfg.save_checkpoint and lead and epoch > cfg.epochs * cfg.checkpoint_after_frac
                    and epoch % cfg.checkpoint_every == 0):
                Path(cfg.dir_checkpoint).mkdir(parents=True, exist_ok=True)
                saves.append(save_checkpoint_async(
                    str(Path(cfg.dir_checkpoint) / f"checkpoint_epoch{epoch}.npz"), model,
                    step=step_fn.step, mask_values=mask_values, optimizer=step_fn.optimizer,
                    executor=saver))
                log.info("Checkpoint %d saved!", epoch)

        for fut in saves:
            fut.result()  # a failed write raises here, before the final save
        if lead:
            save_checkpoint(f"model_epoch{cfg.epochs}.npz", model, step=step_fn.step,
                            mask_values=mask_values, optimizer=step_fn.optimizer)
    finally:
        # on every path, no write outlives the call; on the error path the
        # loop's exception goes on, and a write that failed too is logged
        saver.shutdown(wait=True)
        for fut in saves:
            if fut.exception() is not None:
                log.error("checkpoint write failed: %r", fut.exception())
        mlog.close()
    return step_fn
