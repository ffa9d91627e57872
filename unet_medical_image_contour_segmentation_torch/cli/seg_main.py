#!/usr/bin/env python
"""End-to-end RAW image contour extraction with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.seg_main \\
        --input-raw scans/ --width 1536 --height 1024 -ww 30000 -wl 35000 \\
        -m checkpoint.npz [--device cpu]

The flags, the ``seg_process.log`` handler and the exit codes (0, or 1 when
a stage fails) of the JAX package's ``cli/seg_main.py``; the five stages run
in-process through ``pipeline.seg_main.run_pipeline``; ``--int8`` serves
stage 3 in int8, and ``--int8-scales s.json`` loads its calibration if the
file exists, else saves the first batch's there.
"""

from __future__ import annotations

import argparse
import logging
import sys


def setup_logging() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        handlers=[logging.FileHandler("seg_process.log"), logging.StreamHandler()],
    )


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="End-to-end RAW image contour extraction")
    parser.add_argument("--input-raw", help="Input RAW file or directory")
    parser.add_argument("--output-root", "-o", default="seg_results")
    parser.add_argument("--width", type=int, required=True, help="RAW image width")
    parser.add_argument("--height", type=int, required=True, help="RAW image height")
    parser.add_argument("--window-width", "-ww", type=int, required=True)
    parser.add_argument("--window-length", "-wl", type=int, required=True)
    parser.add_argument("--model", "-m", required=True, help="Prediction checkpoint (.pth/.npz)")
    parser.add_argument("--target-size", type=int, default=512)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 serving for stage 3 (first-batch calibration)")
    parser.add_argument("--int8-scales", default=None, metavar="JSON",
                        help="With --int8: load the activation-scale calibration from this "
                             "JSON if it exists, else save the first batch's there")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    setup_logging()
    args = get_args(argv)

    from ..config import PipelineConfig
    from ..pipeline.seg_main import run_pipeline

    cfg = PipelineConfig(input_raw=args.input_raw, output_root=args.output_root,
                         width=args.width, height=args.height,
                         window_width=args.window_width, window_length=args.window_length,
                         model=args.model, target_size=args.target_size, int8=args.int8,
                         int8_scales=args.int8_scales)
    try:
        result_dir = run_pipeline(cfg, device=args.device)
        logging.info("===== pipeline finished =====")
        logging.info("Final results: %s", result_dir)
        return 0
    except Exception as e:  # the CLI's boundary: log the traceback, exit 1
        logging.error("Pipeline failed: %s", e, exc_info=True)
        return 1


if __name__ == "__main__":
    sys.exit(main())
