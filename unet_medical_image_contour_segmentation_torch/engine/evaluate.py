"""Validation loop: batched device forward, host post-processing in a thread pool.

The port of the JAX package's ``engine/evaluate.py``, with the reference's
semantics:

* multiclass: argmax, Dice computed **only for class 2** (the target contour);
* binary (n_classes == 1): targets //= 2, sigmoid > 0.5;
* optional post-processed Dice via ``pipeline/post_process.py``;
* ``min_dice`` tracked across *batches*, starting at 10;
* optional prediction PNG dumps with the {0->0, 1->128, 2->255} value map.

The forward runs the model itself (BN unfolded) in ``eval()`` mode under
``inference_mode``, so the 3x3 kernel serves it; the device-to-host copy, cv2
and PNG encoding run in worker threads beside the next batch's forward.
cv2, PIL and tqdm are imported only on the paths that use them.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..pipeline.post_process import postprocess_mask

__all__ = ["evaluate", "eval_forward", "make_eval_step"]


def _classes(logits: torch.Tensor, n_classes: int) -> torch.Tensor:
    if n_classes == 1:
        return (torch.sigmoid(logits[..., 0]) > 0.5).int()
    return logits.argmax(dim=-1).int()


def eval_forward(model: nn.Module, image: torch.Tensor, shard=None) -> torch.Tensor:
    """(B, H, W[, C]) image on the model's device -> (B, H, W) int32 classes;
    with a ``shard``, of its band of rows (``parallel/spatial.py``)."""
    logits = model(image) if shard is None else model(image, shard=shard)
    return _classes(logits, model.n_classes)


def make_eval_step(model: nn.Module, n_classes: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """JAX's ``make_eval_step``: the step ``image -> (B, H, W)`` int32
    classes that :func:`evaluate` takes as ``eval_step`` (sigmoid > 0.5 for
    one class, else the argmax).  Each call runs ``model`` in ``eval()``
    mode under ``inference_mode`` and restores its mode."""
    def eval_step(image: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return _classes(model(image), n_classes)
        finally:
            model.train(was_training)
    return eval_step


def _dice_np(pred: np.ndarray, true: np.ndarray, eps: float = 1e-6) -> float:
    """Reference dice_coeff(reduce_batch_first=False) on host arrays [B,H,W]."""
    inter = 2.0 * (pred * true).sum(axis=(-1, -2))
    sets = pred.sum(axis=(-1, -2)) + true.sum(axis=(-1, -2))
    sets = np.where(sets == 0, inter, sets)
    return float(np.mean((inter + eps) / (sets + eps)))


def _save_png(arr: np.ndarray, path: str, value_map=None) -> None:
    from PIL import Image

    out = arr.astype(np.uint8)
    if value_map is not None:
        vis = np.zeros_like(out)
        for src, dst in value_map.items():
            vis[out == src] = dst
        out = vis
    Image.fromarray(out).save(path, compress_level=1)


def evaluate(model: nn.Module, dataloader, *,
             device: Optional[Union[str, torch.device]] = None,
             epoch_pred_dir: Optional[str] = None, postprocess: bool = True,
             progress: bool = False,
             eval_step: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             batch_pad: int = 1) -> Tuple[float, float, float]:
    """Returns (dice_original, dice_postprocessed, min_dice) averaged over
    batches of numpy ``{"image", "mask"}`` dicts.  ``device`` defaults to
    ``cuda``; the model must already be there.  Restores the model's
    train/eval mode on return.

    ``eval_step`` maps a batch on the device to its (B, H, W) int32 classes
    (:func:`make_eval_step`'s by default; the data-parallel step of
    ``parallel/data_parallel.py:make_parallel_eval_step`` shards it over the
    ranks, and ``parallel/spatial.py:make_spatial_eval_step`` over the ranks
    and the images' rows).  A batch whose size is not a multiple of
    ``batch_pad`` is padded by repeating its last sample and its classes
    cropped back before any host work, so the Dice triple is the single
    device's (JAX's ``batch_pad``)."""
    device = resolve_device(device)
    n_classes = model.n_classes
    eval_step = eval_step or make_eval_step(model, n_classes)

    postprocessed_dir = None
    if epoch_pred_dir is not None and postprocess:
        postprocessed_dir = os.path.join(epoch_pred_dir, "postprocessed")
        os.makedirs(postprocessed_dir, exist_ok=True)

    def host_work(batch_index, pred_device, true):
        """Device-to-host copy, cv2 post-process and PNG dumps for one batch;
        -> (dice_orig, dice_post or None, batch_min)."""
        pred = pred_device.cpu().numpy()
        d_post = None
        if n_classes == 1:
            true = true // 2
            d_orig = _dice_np(pred.astype(np.float32), true.astype(np.float32))
            if postprocess:
                # reference quirk: a {0,255} image goes into the {0,1,2}
                # post-process, which zeroes the mask; kept for parity
                post = np.stack([postprocess_mask((pred[i] * 255).astype(np.uint8)) // 255
                                 for i in range(pred.shape[0])])
                d_post = _dice_np(post.astype(np.float32), true.astype(np.float32))
        else:
            d_orig = _dice_np((pred == 2).astype(np.float32), (true == 2).astype(np.float32))
            if postprocess:
                post = np.stack([postprocess_mask(pred[i].astype(np.uint8))
                                 for i in range(pred.shape[0])])
                d_post = _dice_np((post == 2).astype(np.float32),
                                  (true == 2).astype(np.float32))
        current = min(d_orig, d_post) if postprocess and n_classes == 1 else d_orig

        if epoch_pred_dir is not None:
            vm = {0: 0, 1: 255} if n_classes == 1 else {0: 0, 1: 128, 2: 255}
            post_vm = {0: 0, 1: 255} if n_classes == 1 else {0: 0, 2: 255}
            for i in range(pred.shape[0]):
                name = f"pred_batch{batch_index}_sample{i}.png"
                _save_png(pred[i], os.path.join(epoch_pred_dir, name), vm)
                if postprocess:
                    _save_png(post[i], os.path.join(postprocessed_dir, name), post_vm)
        return d_orig, d_post, current

    batches = dataloader
    if progress:
        from tqdm import tqdm

        batches = tqdm(dataloader, total=len(dataloader) if hasattr(dataloader, "__len__")
                       else None, desc="Validation round", unit="batch", leave=False,
                       disable=None)
    was_training = model.training
    model.eval()
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            pending = []
            with torch.inference_mode():
                for batch_index, batch in enumerate(batches, 1):
                    image = np.asarray(batch["image"])
                    n_real = image.shape[0]
                    pad = -n_real % max(1, batch_pad)
                    if pad:
                        image = np.concatenate([image, np.repeat(image[-1:], pad, axis=0)])
                    pred = eval_step(torch.as_tensor(image).to(device))[:n_real]
                    pending.append(pool.submit(host_work, batch_index, pred,
                                               np.asarray(batch["mask"])))
            results = [f.result() for f in pending]
    finally:
        model.train(was_training)

    n = max(len(results), 1)
    dice_original = sum(r[0] for r in results) / n
    dice_postprocessed = sum(r[1] for r in results) / n if postprocess else dice_original
    min_dice = min((r[2] for r in results), default=10.0)  # the reference starts at 10
    return dice_original, dice_postprocessed, min_dice
