#!/usr/bin/env python
"""Predict multiclass contour masks for a file or directory with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.predict \\
        -m checkpoint.npz -i images/ -o masks/ --arch unet_s

The flags of the JAX package's ``cli/predict.py`` that this port supports:
``.pth``/``.pt``/``.npz`` weights of unet, unet_t, unet_s or unet_sa, and
``.npz`` weights of unet_pp, unet_pp_s or yolov8_seg_s (with
``--bilinear`` for bilinear ups), a file or a recursively walked directory,
post-processing on by default, masks saved as {0,128,255} PNGs (next to the
inputs when ``-o`` is omitted), batches grouped by image size, and tiled
serving of images above ``--tile-threshold`` pixels, and int8 serving
(``--int8``, with ``--int8-scales s.json``: load the calibration if the file
exists, else calibrate on the first batch and save it there; not for
yolov8_seg_s, whose int8 path is not ported yet).  A ``.pt2``
program of the export CLI serves through ``ExportedPredictor`` (its
precision, int8 included, was fixed at export time, so ``--int8`` is ignored
with a warning; tile 512 unless ``--tile`` says otherwise).  JAX's
``.stablehlo`` programs, data parallelism and visualisation are rejected
with an error.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

ARCHS = ["unet", "unet_t", "unet_s", "unet_sa", "unet_pp", "unet_pp_s", "yolov8_seg_s"]
# architectures whose int8 path is not ported yet
INT8_NOT_PORTED = ("yolov8_seg_s",)
# flags of the JAX CLI that the port does not serve yet (with their aliases)
_NOT_PORTED = {
    ("--viz", "-v"): "visualisation", ("--num-devices",): "data-parallel serving",
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Predict multiclass masks (.pth/.npz weights "
                                                 "or a .pt2 program)")
    parser.add_argument("--model", "-m", required=True,
                        help="Weights: .pth/.pt state_dict, pickled module or TorchScript; "
                             ".npz; or a .pt2 program of the export CLI")
    parser.add_argument("--input", "-i", required=True, help="Input image file or directory")
    parser.add_argument("--output", "-o", help="Output directory (default: next to the input)")
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
    for flags, what in _NOT_PORTED.items():
        parser.add_argument(*flags, nargs="?", const=True, default=None, help=argparse.SUPPRESS,
                            dest=f"not_ported_{flags[0][2:].replace('-', '_')}")
    args = parser.parse_args(argv)
    for flags, what in _NOT_PORTED.items():
        if getattr(args, f"not_ported_{flags[0][2:].replace('-', '_')}") is not None:
            parser.error(f"{flags[0]}: {what} is not ported to the PyTorch package yet; "
                         "use the JAX package's umics-predict")
    if args.int8 and args.arch in INT8_NOT_PORTED:
        parser.error(f"--arch {args.arch} --int8: int8 serving of {args.arch} is not ported to "
                     "the PyTorch package yet; serve it in float, or use the JAX package's "
                     "umics-predict")
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
        predictor = ExportedPredictor.from_file(
            args.model, device=args.device, batch_size=args.batch_size,
            tile=512 if args.tile is None else args.tile, tile_halo=args.tile_halo,
            tile_threshold=args.tile_threshold)
    else:
        state_dict, _ = load_weights(args.model)
        compute_dtype = torch.bfloat16 if args.device.startswith("cuda") else None
        model = get_model(args.arch, n_channels=1, n_classes=args.classes,
                          bilinear=args.bilinear, compute_dtype=compute_dtype)
        model.load_state_dict(state_dict)
        predictor = Predictor(model, device=args.device, batch_size=args.batch_size,
                              tile=args.tile, tile_halo=args.tile_halo,
                              tile_threshold=args.tile_threshold, quantize=args.int8)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
