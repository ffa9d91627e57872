#!/usr/bin/env python
"""Predict multiclass contour masks for a file or directory with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.predict \\
        -m checkpoint.npz -i images/ -o masks/ --arch unet_s

The flags of the JAX package's ``cli/predict.py`` that this port supports:
``.pth``/``.pt``/``.npz`` weights of unet, unet_t, unet_s or unet_sa (with
``--bilinear`` for bilinear ups), a file or a recursively walked directory,
post-processing on by default, masks saved as {0,128,255} PNGs (next to the
inputs when ``-o`` is omitted), batches grouped by image size, and tiled
serving of images above ``--tile-threshold`` pixels.  Its other flags (int8,
data parallelism, exported programs, visualisation) are rejected with an
error until they are ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

# flags of the JAX CLI that the port does not serve yet
_NOT_PORTED = {
    "--viz": "visualisation", "--num-devices": "data-parallel serving",
    "--int8": "int8 serving", "--int8-scales": "int8 serving",
}


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Predict multiclass masks (.pth/.npz weights)")
    parser.add_argument("--model", "-m", required=True,
                        help="Weights: .pth/.pt state_dict, pickled module or TorchScript; .npz")
    parser.add_argument("--input", "-i", required=True, help="Input image file or directory")
    parser.add_argument("--output", "-o", help="Output directory (default: next to the input)")
    parser.add_argument("--no-save", "-n", action="store_true", default=False)
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
    parser.add_argument("--arch", default="unet", choices=["unet", "unet_t", "unet_s", "unet_sa"],
                        help="Architecture of the weight file")
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--bilinear", action="store_true", default=False,
                        help="The weights are of a UNet with bilinear ups")
    parser.add_argument("--fast-transfer", action="store_true", default=False,
                        help="Upload raw uint8 pixels and normalise on the device")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu")
    for flag, what in _NOT_PORTED.items():
        parser.add_argument(flag, nargs="?", const=True, default=None, help=argparse.SUPPRESS,
                            dest=f"not_ported_{flag[2:].replace('-', '_')}")
    args = parser.parse_args(argv)
    for flag, what in _NOT_PORTED.items():
        if getattr(args, f"not_ported_{flag[2:].replace('-', '_')}") is not None:
            parser.error(f"{flag}: {what} is not ported to the PyTorch package yet; "
                         "use the JAX package's umics-predict")
    if args.model.endswith(".stablehlo"):
        parser.error("--model: exported .stablehlo programs are not served by the "
                     "PyTorch package yet")
    return args


def main(argv=None) -> int:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import torch

    from ..engine.checkpoint import load_weights
    from ..engine.predict import Predictor, collect_image_files
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

    state_dict, _ = load_weights(args.model)
    compute_dtype = torch.bfloat16 if args.device.startswith("cuda") else None
    model = get_model(args.arch, n_channels=1, n_classes=args.classes,
                      bilinear=args.bilinear, compute_dtype=compute_dtype)
    model.load_state_dict(state_dict)
    predictor = Predictor(model, device=args.device, batch_size=args.batch_size,
                          tile=args.tile, tile_halo=args.tile_halo,
                          tile_threshold=args.tile_threshold)
    logging.info("Model loaded on %s", predictor.device)
    results = predictor.predict_paths(in_files, output_dir=args.output,
                                      postprocess=args.postprocess, save=not args.no_save,
                                      fast_transfer=args.fast_transfer)
    logging.info("Predicted %d/%d images", len(results), len(in_files))
    return 0


if __name__ == "__main__":
    sys.exit(main())
