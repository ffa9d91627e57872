"""The configs and their argparse helpers: the port's own copy of the JAX
package's ``config.py`` (``TrainConfig``, ``PostProcessConfig``,
``PipelineConfig``, ``add_dataclass_args``, ``dataclass_from_args``), field
for field, so one config drives either package.  ``amp`` is bf16 compute
with f32 master weights and no loss scaling.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["TrainConfig", "PostProcessConfig", "PipelineConfig", "add_dataclass_args",
           "dataclass_from_args"]


@dataclasses.dataclass
class TrainConfig:
    # model
    model: str = "unet_s"                  # unet | unet_t | unet_s | unet_sa
    n_channels: int = 1
    classes: int = 3
    bilinear: bool = False
    remat: bool = False                    # activation checkpointing
    # data
    data_root: str = "data/data-without-black-shadow"
    scale: float = 0.5
    augment: bool = True
    num_workers: int = 8
    # optimization (reference train.py defaults)
    epochs: int = 5
    batch_size: int = 1
    learning_rate: float = 1e-5
    weight_decay: float = 1e-8
    momentum: float = 0.999
    gradient_clipping: float = 1.0
    amp: bool = True                       # bf16 compute, f32 master weights
    # loss
    boundary_weight: float = 0.25
    boundary_edge_width: int = 51
    boundary_edge_weight: float = 15.0
    cc_loss: bool = False                  # opt-in connected-component penalty
    # schedule
    sched_t0: int = 4
    sched_t_mult: int = 2
    sched_eta_min: float = 1e-7
    scheduler_quirk: bool = True           # faithful step(val_score); False -> step(epoch)
    # checkpointing
    save_checkpoint: bool = True
    dir_checkpoint: str = "./checkpoints"
    checkpoint_every: int = 5
    checkpoint_after_frac: float = 0.5
    load: Optional[str] = None
    # evaluation
    val_postprocess: bool = True
    predictions_dir: str = "./predictions"
    save_val_predictions: bool = True
    # parallelism
    num_devices: Optional[int] = None      # None: one device, as JAX's engine reads it;
                                           # N > 1: N data-parallel ranks (engine/train.py)
    spatial_shards: int = 1                # > 1: image rows over that many ranks, beside
                                           # num_devices / spatial_shards data-parallel ones
    # misc
    seed: int = 0
    log_every: int = 10
    sample_cache_bytes: int = 0            # decoded-sample RAM cache (0 = off)
    disk_cache_dir: Optional[str] = None   # persistent decoded-sample cache
    nan_check_every: int = 1               # steps between NaN-guard/metric fetches
    progress: bool = True                  # tqdm running-loss bar (auto-off on non-TTY)
    metrics_path: Optional[str] = None     # JSONL per-step/epoch metric log


@dataclasses.dataclass
class PostProcessConfig:
    min_area: int = 15000
    morph_kernel_size: int = 3


@dataclasses.dataclass
class PipelineConfig:
    """The knobs of the 5-stage RAW -> contour-JSON pipeline."""

    input_raw: str = ""
    output_root: str = "seg_results"
    width: int = 0
    height: int = 0
    window_width: int = 0
    window_length: int = 0
    model: str = ""
    target_size: int = 512
    int8: bool = False                     # int8 serving of stage 3
    int8_scales: Optional[str] = None      # its calibration JSON (load, else save)


def add_dataclass_args(parser, cls, defaults=None):
    """Register every dataclass field as a --flag (bools get true/false)."""
    defaults = defaults or cls()
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        default = getattr(defaults, f.name)
        if f.type in ("bool", bool):
            parser.add_argument(
                name, type=lambda s: s.lower() in ("1", "true", "yes"),
                default=default, metavar="{true,false}",
            )
        elif f.type in ("Optional[str]", "Optional[int]"):
            parser.add_argument(name, default=default)
        else:
            typ = {"int": int, "float": float, "str": str}.get(str(f.type), str)
            parser.add_argument(name, type=typ, default=default)
    return parser


def dataclass_from_args(cls, args):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in vars(args).items() if k in names})
