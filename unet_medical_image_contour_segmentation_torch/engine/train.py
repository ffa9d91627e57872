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

* with ``cc_loss`` (binary models only), the connected-component penalty
  scored on the host on that same delayed fetch and added to the logged
  loss value, never to the gradient (JAX's ``check_nan``); the fetch window
  is then clamped to 8 steps, since each queued step holds a (B, H, W)
  probability map on the card.

The whole UNet family trains (``unet``, ``unet_t``, ``unet_s``, ``unet_sa``,
bilinear or ConvTranspose ups, ``remat``), and UNet++ (``unet_pp``,
``unet_pp_s``, ``remat`` per node) and YOLOv8-seg (``yolov8_seg_s``), with
the binary or multiclass criterion.  Single device only: data and spatial parallelism raise
``NotImplementedError`` until they are ported.  tqdm, PIL and cv2 are
imported only on the paths that use them (progress bars, prediction dumps,
post-processed Dice, the connected-component penalty).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..config import TrainConfig
from ..device import resolve_device
from ..losses.compound import LossConfig, compute_loss
from ..models.torch_compat import state_dict_from_jax
from .checkpoint import save_checkpoint
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
    """

    def __init__(self, model: nn.Module, loss_cfg: LossConfig, opt_cfg: RMSpropConfig,
                 clipping: float = 1.0):
        self.model = model
        self.loss_cfg = loss_cfg
        self.clipping = clipping
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = make_optimizer(self.params, opt_cfg)
        self.step = 0

    def __call__(self, batch: Dict[str, torch.Tensor], lr: float) -> Dict[str, torch.Tensor]:
        self.model.train()
        logits = self.model(batch["image"])
        loss, metrics = compute_loss(logits, batch["mask"], self.loss_cfg)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        grad_norm = clip_by_global_norm([p.grad for p in self.params], self.clipping)
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


def _refuse_unported(cfg: TrainConfig) -> None:
    unported = {
        "num_devices > 1 (data parallelism)": (cfg.num_devices or 1) > 1,
        "spatial_shards > 1 (spatial parallelism)": cfg.spatial_shards > 1,
    }
    asked = [what for what, on in unported.items() if on]
    if asked:
        raise NotImplementedError("not ported to the PyTorch package yet: " + ", ".join(asked))


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
    """
    from ..data.dataset import BasicDataset
    from ..data.loader import DataLoader, prefetch_to_device
    from ..models.unet import get_model
    from ..utils.metrics import MetricLogger

    _refuse_unported(cfg)
    if cfg.cc_loss and cfg.classes != 1:
        # the penalty is part of the binary loss only (the reference ships it
        # commented out inside its n_classes == 1 branch)
        log.warning("--cc-loss has no effect with classes=%d: the connected-component "
                    "penalty is part of the binary (classes=1) loss only", cfg.classes)
    device = resolve_device(device)
    if model is None:
        model = get_model(cfg.model, n_channels=cfg.n_channels, n_classes=cfg.classes,
                          bilinear=cfg.bilinear, remat=cfg.remat,
                          compute_dtype=torch.bfloat16 if cfg.amp else None)
    if train_set is None:
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

    train_loader = DataLoader(train_set, cfg.batch_size, shuffle=True,
                              num_workers=cfg.num_workers, seed=cfg.seed)
    val_loader = DataLoader(val_set, cfg.batch_size, shuffle=False, drop_last=True,
                            num_workers=cfg.num_workers)
    n_train = len(train_set)
    log.info("Starting training: epochs=%d batch=%d lr=%g scale=%g amp(bf16)=%s model=%s "
             "device=%s", cfg.epochs, cfg.batch_size, cfg.learning_rate, cfg.scale, cfg.amp,
             model.name, device)

    loss_cfg = LossConfig(n_classes=model.n_classes, boundary_weight=cfg.boundary_weight,
                          boundary_edge_width=cfg.boundary_edge_width,
                          boundary_edge_weight=cfg.boundary_edge_weight,
                          connected_component=cfg.cc_loss, cc_emit_probs=True)
    opt_cfg = RMSpropConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                            momentum=cfg.momentum)
    if state is not None:
        model.load_state_dict(state_dict_from_jax(state["params"], state["bn_state"]))
    model.to(device)
    step_fn = TrainStep(model, loss_cfg, opt_cfg, cfg.gradient_clipping)
    if state is not None:
        step_fn.step = int(state["step"])
        if state.get("opt_state") is not None:
            load_opt_state(model, step_fn.optimizer, state["opt_state"], step_fn.step)

    mlog = MetricLogger(cfg.metrics_path, backends=metric_backends)
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
        connected-component penalty joins the logged loss."""
        if not pending:
            return 0.0, None
        keys = [k for k in pending[0][1] if k != "cc_probs"]
        host = torch.stack([torch.stack([m[k].float() for k in keys])
                            for _, m in pending]).cpu().numpy()
        probs = None
        if "cc_probs" in pending[0][1]:
            from ..losses.connected_component import connected_component_loss

            probs = [m["cc_probs"].cpu().numpy() for _, m in pending]
        total = last = 0.0
        for i, ((step_idx, _), row) in enumerate(zip(pending, host)):
            metrics = dict(zip(keys, row.tolist()))
            if probs is not None:
                metrics["cc"] = connected_component_loss(
                    probs[i], edge_distance=loss_cfg.cc_edge_distance,
                    min_area=loss_cfg.cc_min_area, penalty_weight=loss_cfg.cc_penalty_weight)
                metrics["loss"] += metrics["cc"]
            last = metrics["loss"]
            if not np.isfinite(last):
                raise RuntimeError("Fatal: NaN loss detected!")
            mlog.log("train_step", step=step_idx, **metrics)
            total += last
        pending.clear()
        return total, last

    try:
        for epoch in range(1, cfg.epochs + 1):
            epoch_loss = 0.0
            epoch_pred_dir = None
            if cfg.save_val_predictions:
                epoch_pred_dir = Path(cfg.predictions_dir) / f"epoch_{epoch}"
                epoch_pred_dir.mkdir(parents=True, exist_ok=True)

            pbar = None
            if cfg.progress:
                from tqdm import tqdm

                # disable=None hides the bar on a non-TTY stderr
                pbar = tqdm(total=n_train, desc=f"Epoch {epoch}/{cfg.epochs}", unit="img",
                            disable=None)
            t0 = time.perf_counter()
            n_seen = 0
            for batch in prefetch_to_device(iter(train_loader), device):
                image = batch["image"]
                n_ch = 1 if image.dim() == 3 else image.shape[-1]
                if n_ch != model.n_channels:
                    raise ValueError(f"Network has been defined with {model.n_channels} input "
                                     f"channels, but loaded images have {n_ch} channels.")
                metrics = step_fn(batch, lr)
                n_seen += image.shape[0]
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
                postprocess=cfg.val_postprocess, progress=cfg.progress)
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

            if (cfg.save_checkpoint and epoch > cfg.epochs * cfg.checkpoint_after_frac
                    and epoch % cfg.checkpoint_every == 0):
                Path(cfg.dir_checkpoint).mkdir(parents=True, exist_ok=True)
                save_checkpoint(str(Path(cfg.dir_checkpoint) / f"checkpoint_epoch{epoch}.npz"),
                                model, step=step_fn.step, mask_values=mask_values,
                                optimizer=step_fn.optimizer)
                log.info("Checkpoint %d saved!", epoch)

        save_checkpoint(f"model_epoch{cfg.epochs}.npz", model, step=step_fn.step,
                        mask_values=mask_values, optimizer=step_fn.optimizer)
    finally:
        mlog.close()
    return step_fn
