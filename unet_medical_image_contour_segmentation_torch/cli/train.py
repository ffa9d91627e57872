#!/usr/bin/env python
"""Train a UNet, UNet++ or YOLOv8-seg for contour segmentation with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.train \\
        --data-root data/ --epochs 5 --batch-size 8 --model unet_s

The flags of the JAX package's ``cli/train.py``, with its defaults (epochs 5, batch 1, lr 1e-5, scale 0.5, 3 classes, bf16
compute, a 2 GB decoded-sample RAM cache): the imgs/{train,val} +
masks/{train,val} layout under ``--data-root``; ``--model`` over the UNet
family (``unet``, ``unet_t``, ``unet_s``, ``unet_sa``), UNet++
(``unet_pp``, ``unet_pp_s``) and YOLOv8-seg (``yolov8_seg_s``), and
``--bilinear``;
``--classes 1`` for the binary BCE + Dice + boundary criterion and
``--cc-loss`` for its connected-component penalty; ``--remat``;
``--sample-cache-gb`` and ``--disk-cache-dir``; ``--load`` of a ``.npz``
checkpoint of either package (a full resume: weights, BN statistics,
optimizer state, step), of ``latest`` in ``./checkpoints``, or of a
reference ``.pth`` (weights and BN statistics of the UNet the flags name;
UNet++ and YOLOv8-seg have no ``.pth``, as in the JAX package).
As the JAX CLI does, a run that runs out of device memory is run again
from the start with ``remat`` on.

Data parallelism: ``--num-devices N`` trains on N cards of this host
(``train_model`` spawns one process per card; ``-b`` is the global batch).
Across hosts, start one process per card on every host with
``--distributed --coordinator-address HOST:PORT --num-processes P
--process-id I`` (P processes in all, I their global rank; rank 0 listens
at HOST:PORT), or ``--distributed`` alone under a launcher that sets
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` (torchrun).

Spatial parallelism: ``--spatial-shards S`` cuts every image's rows over S
ranks of this host (beside ``--num-devices / S`` data-parallel ones; all
the host's cards by default); H must be divisible by S times the model's
pooling divisor (16 for the UNets, 32 for ``yolov8_seg_s``, which also
needs H >= S * 64).  Single-host only.
"""

from __future__ import annotations

import argparse
import logging
import sys



def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Train the UNet on images and target masks")
    parser.add_argument("--epochs", "-e", metavar="E", type=int, default=5)
    parser.add_argument("--batch-size", "-b", dest="batch_size", metavar="B", type=int,
                        default=1)
    parser.add_argument("--learning-rate", "-l", metavar="LR", type=float, default=1e-5,
                        dest="lr")
    parser.add_argument("--load", "-f", type=str, default=None,
                        help="Resume from a .npz checkpoint, 'latest', or load .pth weights")
    parser.add_argument("--scale", "-s", type=float, default=0.5,
                        help="Downscaling factor of the images")
    parser.add_argument("--validation", "-v", dest="val", type=float, default=10.0,
                        help="Accepted for reference CLI compatibility and ignored: the "
                             "split is directory-based (imgs/train vs imgs/val)")
    parser.add_argument("--amp", action="store_true", default=True,
                        help="bf16 compute with f32 master weights (the default)")
    parser.add_argument("--no-amp", dest="amp", action="store_false", help="Full f32 compute")
    parser.add_argument("--no-save-val-predictions", dest="save_val_predictions",
                        action="store_false", default=True,
                        help="Skip the per-epoch prediction PNG dumps")
    parser.add_argument("--no-val-postprocess", dest="val_postprocess",
                        action="store_false", default=True,
                        help="Skip the cv2 post-processed Dice during validation")
    parser.add_argument("--bilinear", action="store_true", default=False,
                        help="Use bilinear upsampling")
    parser.add_argument("--classes", "-c", type=int, default=3,
                        help="Number of classes (1: the binary boundary criterion)")
    parser.add_argument("--model", "-m", default="unet_s",
                        choices=["unet", "unet_t", "unet_s", "unet_sa", "unet_pp", "unet_pp_s",
                                 "yolov8_seg_s"],
                        help="Model variant")
    parser.add_argument("--data-root", default="data/data-without-black-shadow")
    parser.add_argument("--remat", action="store_true", default=False,
                        help="Rematerialize blocks (activation checkpointing)")
    parser.add_argument("--sample-cache-gb", type=float, default=2.0,
                        help="RAM budget for decoded samples (0 disables)")
    parser.add_argument("--disk-cache-dir", default=None,
                        help="Persistent decoded-sample cache directory (.npz per "
                             "id/rotation/scale, mtime-validated)")
    parser.add_argument("--nan-check-every", type=int, default=1,
                        help="Steps between NaN-guard/metric fetches")
    parser.add_argument("--no-scheduler-quirk", dest="scheduler_quirk", action="store_false",
                        default=True, help="Step the LR schedule by epoch instead of by Dice")
    parser.add_argument("--cc-loss", action="store_true", default=False,
                        help="Add the connected-component penalty to the binary loss "
                             "(a host term on the logged value, no gradient)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Data-parallel device count (default: single device)")
    parser.add_argument("--spatial-shards", type=int, default=1,
                        help="Split each image's rows over this many devices (2-D data x "
                             "spatial layout with --num-devices)")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="Join a torch.distributed group (multi-host training)")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of rank 0")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    args = parser.parse_args(argv)
    if args.spatial_shards < 1:
        parser.error(f"--spatial-shards must be at least 1, not {args.spatial_shards}")
    if args.num_devices is not None and args.num_devices < 1:
        parser.error(f"--num-devices must be at least 1, not {args.num_devices}")
    return args


def _out_of_memory(e: BaseException) -> bool:
    """The JAX CLI's test, plus torch's own out-of-memory error, also as a
    spawned rank's traceback."""
    import torch

    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        isinstance(e, RuntimeError)
        and any(k in str(e) for k in ("RESOURCE_EXHAUSTED", "Out of memory",
                                      "OutOfMemoryError")))


def _train_with_retry(cfg, state, device) -> None:
    """train_model, run once more with remat on after an out-of-memory error."""
    import torch

    from ..engine.train import train_model

    # the retry runs outside the handler, so that the failed run's traceback
    # (and the tensors its frames hold) is gone before it starts
    out_of_memory = False
    try:
        train_model(cfg, state=state, device=device)
    except RuntimeError as e:  # torch.cuda.OutOfMemoryError is one
        if not _out_of_memory(e):
            raise
        out_of_memory = True
    if out_of_memory:
        logging.error("Detected OutOfMemoryError! Enabling rematerialization to reduce "
                      "memory usage, but this slows down training.")
        torch.cuda.empty_cache()
        cfg.remat = True
        train_model(cfg, state=state, device=device)


def main(argv=None) -> int:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    if args.distributed or args.coordinator_address:
        from ..parallel import distributed

        distributed.initialize(args.coordinator_address, args.num_processes,
                               args.process_id, device=args.device)

    from ..config import TrainConfig
    from ..engine.checkpoint import latest_checkpoint, load_checkpoint, load_weights
    from ..models.torch_compat import params_from_state_dict

    cfg = TrainConfig(model=args.model, classes=args.classes, bilinear=args.bilinear,
                      remat=args.remat, data_root=args.data_root,
                      scale=args.scale, epochs=args.epochs, batch_size=args.batch_size,
                      learning_rate=args.lr, amp=args.amp, scheduler_quirk=args.scheduler_quirk,
                      cc_loss=args.cc_loss, load=args.load, num_devices=args.num_devices,
                      spatial_shards=args.spatial_shards,
                      save_val_predictions=args.save_val_predictions,
                      val_postprocess=args.val_postprocess,
                      nan_check_every=args.nan_check_every,
                      sample_cache_bytes=int(args.sample_cache_gb * 1e9),
                      disk_cache_dir=args.disk_cache_dir)

    state = None
    if cfg.load == "latest":
        cfg.load = latest_checkpoint(cfg.dir_checkpoint)
        if cfg.load is None:
            logging.info("No checkpoint found in %s; starting fresh", cfg.dir_checkpoint)
    if cfg.load:
        if str(cfg.load).endswith(".npz"):
            state = load_checkpoint(cfg.load)  # weights, BN stats, optimizer state, step
        else:
            # reference .pth: weights + BN stats of the UNet the flags name
            state_dict, _ = load_weights(cfg.load, bilinear=cfg.bilinear,
                                         use_attention=cfg.model == "unet_sa")
            params, bn_state, _ = params_from_state_dict(state_dict)
            state = {"params": params, "bn_state": bn_state, "opt_state": None, "step": 0}
        logging.info("Model loaded from %s", cfg.load)

    import torch.distributed as dist

    try:
        _train_with_retry(cfg, state, args.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
