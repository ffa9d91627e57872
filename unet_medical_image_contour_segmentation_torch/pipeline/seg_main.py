"""End-to-end RAW -> contour-JSON pipeline, in one process.

The port of the JAX package's ``pipeline/seg_main.py:run_pipeline``.  The
five stages are library calls: RAW -> windowed PNG, the 512x512 letterbox,
the prediction (every letterboxed PNG through the port's Predictor, on the
card unless the caller asks for the CPU), the inverse letterbox, and the
labelme polygon JSON with its overlay.  The on-disk contract is the JAX
package's: stage directories ``1_raw_png`` .. ``5_json_results``, the
geometry threaded through ``original_sizes.json``, and an error when a stage
writes nothing.  Each stage logs its seconds.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict, Optional, Union

import torch

from ..config import PipelineConfig
from .letterbox import PngDenormalizer, PngNormalizer
from .mask2polygon import MaskProcessor
from .raw2png import RawToPngConverter

__all__ = ["STAGES", "create_work_dirs", "run_pipeline"]

log = logging.getLogger(__name__)

STAGES = {
    "raw_png": "1_raw_png",
    "normalized_png": "2_normalized_png",
    "pred_masks": "3_pred_masks",
    "denormalized_masks": "4_denormalized_masks",
    "json_results": "5_json_results",
}


def create_work_dirs(root_dir: str) -> Dict[str, str]:
    dirs = {k: os.path.join(root_dir, v) for k, v in STAGES.items()}
    for d in dirs.values():
        Path(d).mkdir(parents=True, exist_ok=True)
    return dirs


def _check_nonempty(stage: str, directory: str) -> None:
    if not os.listdir(directory):
        raise RuntimeError(f"{stage} produced no output files, aborting pipeline")


def run_pipeline(cfg: PipelineConfig, predictor=None,
                 device: Optional[Union[str, torch.device]] = None) -> str:
    """Run all five stages; returns the json_results directory.

    ``predictor``: an ``engine.predict.Predictor``; when omitted one is built
    from ``cfg.model`` (a ``.pth``/``.npz`` checkpoint of ``unet(1, 3)``) on
    ``device`` (``cuda`` by default).  ``cfg.int8`` raises: int8 serving is
    not ported yet.
    """
    if cfg.int8:
        raise NotImplementedError("int8 serving (cfg.int8) is not ported to the PyTorch "
                                  "package yet")
    dirs = create_work_dirs(cfg.output_root)
    sizes_json = os.path.join(dirs["normalized_png"], "original_sizes.json")

    log.info("===== stage 1: RAW -> PNG =====")
    t0 = time.perf_counter()
    converted, failed = RawToPngConverter(
        input_path=cfg.input_raw, output_dir=dirs["raw_png"], width=cfg.width,
        height=cfg.height, window_width=cfg.window_width,
        window_length=cfg.window_length).convert()
    log.info("stage 1: %d converted, %d failed, %.3f s", converted, failed,
             time.perf_counter() - t0)
    _check_nonempty("stage 1 (raw2png)", dirs["raw_png"])

    log.info("===== stage 2: normalize PNG -> %dx%d =====", cfg.target_size, cfg.target_size)
    t0 = time.perf_counter()
    PngNormalizer(input_path=dirs["raw_png"], output_path=dirs["normalized_png"],
                  target_size=cfg.target_size).normalize()
    log.info("stage 2: %.3f s", time.perf_counter() - t0)
    _check_nonempty("stage 2 (png_normalize)", dirs["normalized_png"])

    log.info("===== stage 3: contour prediction =====")
    t0 = time.perf_counter()
    if predictor is None:
        predictor = _build_predictor(cfg.model, device)
    norm_pngs = [os.path.join(dirs["normalized_png"], f)
                 for f in sorted(os.listdir(dirs["normalized_png"])) if f.endswith(".png")]
    if not norm_pngs:
        raise RuntimeError("stage 3 found no normalized PNGs, aborting pipeline")
    predictor.predict_paths(norm_pngs, output_dir=dirs["pred_masks"], postprocess=True)
    log.info("stage 3: %.3f s", time.perf_counter() - t0)
    _check_nonempty("stage 3 (predict)", dirs["pred_masks"])

    log.info("===== stage 4: denormalize masks =====")
    t0 = time.perf_counter()
    PngDenormalizer(input_path=dirs["pred_masks"], output_path=dirs["denormalized_masks"],
                    original_sizes_json=sizes_json, target_size=cfg.target_size).denormalize()
    log.info("stage 4: %.3f s", time.perf_counter() - t0)
    _check_nonempty("stage 4 (png_denormalize)", dirs["denormalized_masks"])

    log.info("===== stage 5: mask -> polygon =====")
    t0 = time.perf_counter()
    MaskProcessor(input_path=dirs["denormalized_masks"], output_path=dirs["json_results"],
                  sizes_json_path=sizes_json).process()
    log.info("stage 5: %.3f s", time.perf_counter() - t0)
    _check_nonempty("stage 5 (mask2polygon)", dirs["json_results"])

    log.info("===== pipeline complete: %s =====", dirs["json_results"])
    return dirs["json_results"]


def _build_predictor(model_path: str, device: Optional[Union[str, torch.device]] = None):
    """The reference's default model, ``unet(1, 3, bilinear=False)``, from a
    ``.pth``/``.npz`` checkpoint: bf16 on the card, f32 on the CPU.  Stage 2
    letterboxes every slice to 512x512, so the tiled path never runs here."""
    from ..device import resolve_device
    from ..engine.checkpoint import load_weights
    from ..engine.predict import Predictor
    from ..models.unet import unet

    device = resolve_device(device)
    state_dict, _ = load_weights(model_path)
    model = unet(n_channels=1, n_classes=3, bilinear=False,
                 compute_dtype=torch.bfloat16 if device.type == "cuda" else None)
    model.load_state_dict(state_dict)
    return Predictor(model, device=device)
