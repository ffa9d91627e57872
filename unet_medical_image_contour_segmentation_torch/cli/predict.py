#!/usr/bin/env python
"""Predict multiclass contour masks for a file or directory with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.predict \\
        -m checkpoint.npz -i images/ -o masks/ --arch unet_s

The flags of the JAX package's ``cli/predict.py`` that this port supports:
``.pth``/``.pt``/``.npz`` weights of unet, unet_t, unet_s or unet_sa, and
``.npz`` weights of unet_pp, unet_pp_s or yolov8_seg_s (with
``--bilinear`` for bilinear ups), ``.pth`` or ``.npz`` weights of
``transunet_r50_b16`` (the published TransUNet state_dict; it serves
images dense in float, H and W multiples of 16, its 512² position
embeddings resampled at other sizes, so ``--int8`` and ``--tile`` are
refused), a
file or a recursively walked directory,
post-processing on by default, masks saved as {0,128,255} PNGs (next to the
inputs when ``-o`` is omitted), batches grouped by image size, and tiled
serving of images above ``--tile-threshold`` pixels, and int8 serving
(``--int8``, with ``--int8-scales s.json``: load the calibration if the file
exists, else calibrate on the first batch and save it there).  A ``.pt2``
program of the export CLI serves through ``ExportedPredictor`` (its
precision, int8 included, was fixed at export time, so ``--int8`` is ignored
with a warning; tile 512 unless ``--tile`` says otherwise).
``--num-devices N`` serves data-parallel on N cards (one replica each; a
``.pt2`` program stays on one device and ignores it with a warning, as the
JAX CLI does for its programs), and ``--viz`` / ``-v`` shows each image
beside its mask with matplotlib (``utils/viz.py``), which must be installed.
JAX's ``.stablehlo`` programs are rejected with an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

ARCHS = ["unet", "unet_t", "unet_s", "unet_sa", "unet_pp", "unet_pp_s", "yolov8_seg_s",
         "transunet_r50_b16"]


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Predict multiclass masks (.pth/.npz weights "
                                                 "or a .pt2 program)")
    parser.add_argument("--model", "-m", required=True,
                        help="Weights: .pth/.pt state_dict, pickled module or TorchScript; "
                             ".npz; or a .pt2 program of the export CLI")
    parser.add_argument("--input", "-i", required=True, help="Input image file or directory")
    parser.add_argument("--output", "-o", help="Output directory (default: next to the input)")
    parser.add_argument("--viz", "-v", action="store_true", default=False,
                        help="Show each image and its mask (matplotlib)")
    parser.add_argument("--no-save", "-n", action="store_true", default=False)
    parser.add_argument("--postprocess", "-p", action="store_true", default=True,
                        help="Clean up the masks with cv2 (the default; the JAX CLI's flag)")
    parser.add_argument("--no-postprocess", dest="postprocess", action="store_false",
                        default=True, help="Skip the cv2 mask clean-up")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--tile", type=int, default=None,
                        help="Tile size for large scans (default: auto, 512, or 1024 on "
                             "grids of at least 8 tiles)")
    parser.add_argument("--tile-halo", type=int, default=96,
                        help="Tile overlap margin (96 covers the UNets' receptive field)")
    parser.add_argument("--tile-threshold", type=int, default=None,
                        help="Pixel count above which images are tiled (default 1536^2; "
                             "0 disables)")
    parser.add_argument("--arch", default="unet", choices=ARCHS,
                        help="Architecture of the weight file")
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--bilinear", action="store_true", default=False,
                        help="The weights are of a UNet with bilinear ups")
    parser.add_argument("--fast-transfer", action="store_true", default=False,
                        help="Upload raw uint8 pixels and normalise on the device")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="int8 serving: per-channel weight quantisation and "
                             "first-batch activation calibration")
    parser.add_argument("--int8-scales", default=None, metavar="JSON",
                        help="With --int8: load the activation-scale calibration from this "
                             "JSON if it exists, else calibrate on the first batch and save "
                             "it there")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="Serve data-parallel over this many devices (batch sharded, "
                             "weights replicated)")
    args = parser.parse_args(argv)
    if args.num_devices is not None and args.num_devices < 1:
        parser.error(f"--num-devices must be at least 1, not {args.num_devices}")
    if args.model.endswith(".stablehlo"):
        parser.error("--model: .stablehlo programs are the JAX package's (its umics-predict "
                     "serves them); export a .pt2 program with this package's export CLI")
    return args


def main(argv=None) -> int:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import torch

    from ..engine.checkpoint import load_weights
    from ..engine.predict import ExportedPredictor, Predictor, collect_image_files
    from ..models.unet import get_model

    if os.path.isdir(args.input):
        in_files = collect_image_files(args.input)
        logging.info("Found %d image files in directory", len(in_files))
        if not in_files:
            logging.error("No image files found in %s", args.input)
            return 1
    elif os.path.isfile(args.input):
        in_files = [args.input]
    else:
        logging.error("Input file does not exist: %s", args.input)
        return 1

    if args.model.endswith(".pt2"):
        if args.int8:
            logging.warning("--int8 is ignored for .pt2 programs (the program's precision is "
                            "fixed at export time); export with --int8 for an int8 program, "
                            "which serves here with no flags")
            args.int8 = False
        if args.num_devices and args.num_devices > 1:
            logging.warning("--num-devices is ignored for .pt2 programs: a program serves on "
                            "the one device it was exported on; serve the weights for "
                            "data-parallel serving")
        predictor = ExportedPredictor.from_file(
            args.model, device=args.device, batch_size=args.batch_size,
            tile=512 if args.tile is None else args.tile, tile_halo=args.tile_halo,
            tile_threshold=args.tile_threshold)
    else:
        state_dict, _ = load_weights(args.model)
        compute_dtype = torch.bfloat16 if args.device.startswith("cuda") else None
        model = get_model(args.arch, n_channels=1, n_classes=args.classes,
                          bilinear=args.bilinear or args.arch.startswith("transunet"),
                          compute_dtype=compute_dtype)
        model.load_state_dict(state_dict)
        predictor = Predictor(model, device=args.device, batch_size=args.batch_size,
                              tile=args.tile, tile_halo=args.tile_halo,
                              tile_threshold=args.tile_threshold, quantize=args.int8,
                              num_devices=args.num_devices)
    logging.info("Model loaded on %s", predictor.device)
    scales = args.int8_scales if args.int8 else None
    if scales and os.path.exists(scales):
        predictor.load_calibration(scales)
        logging.info("Loaded int8 calibration from %s", scales)
    results = predictor.predict_paths(in_files, output_dir=args.output,
                                      postprocess=args.postprocess, save=not args.no_save,
                                      fast_transfer=args.fast_transfer)
    logging.info("Predicted %d/%d images", len(results), len(in_files))
    if scales and not os.path.exists(scales) and predictor._amax is not None:
        predictor.save_calibration(scales)
        logging.info("Saved int8 calibration to %s", scales)
    if args.viz:
        from PIL import Image

        from ..utils.viz import plot_img_and_mask

        for path, mask in results.items():
            plot_img_and_mask(Image.open(path).convert("L"), mask)
    return 0


if __name__ == "__main__":
    sys.exit(main())
