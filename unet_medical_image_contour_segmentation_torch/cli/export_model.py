#!/usr/bin/env python
"""Export a trained checkpoint as a ``torch.export`` program and/or ONNX,
with a sanity forward of each, with the PyTorch port.

    python -m unet_medical_image_contour_segmentation_torch.cli.export_model \\
        -m checkpoints/model.pth -o model.pt2 --arch unet_s

The JAX package's ``cli/export_model.py`` with its flags and defaults: the
weights (``.pth``/``.pt``/``.npz``, mask_values stripped) of a UNet of the
family, or the ``.npz`` weights of a UNet++ or YOLOv8-seg (``--arch``,
``--classes``, ``--bilinear``) export with a dynamic batch and dynamic H and
W (multiples of the model's ``hw_divisor``: 16, or 32 for YOLOv8-seg;
``--static`` fixes 1x512x512).
``--format pt2`` (the default, the port's counterpart of StableHLO: a
``.pt2`` program served by ``predict -m x.pt2``), ``onnx`` (the reference's
deployment contract: opset 11, NCHW, dynamic batch / height / width) or
``both``; without ``--format`` the output's extension decides.  ``--int8``
exports the int8 program instead (weights and requant scales baked in,
static ``--int8-hw``, dynamic batch) from ``--int8-scales`` or from
``--calib`` images (not for yolov8_seg_s, whose int8 path is not ported
yet).  The program is traced on ``--device`` (default cuda) and serves
there.  ``stablehlo`` is refused: it is the JAX package's.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from .predict import ARCHS, INT8_NOT_PORTED


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="Export a checkpoint to a .pt2 program / ONNX")
    parser.add_argument("--model", "-m", default="checkpoints/model_S_boundary_512x512.pth",
                        help="Checkpoint (.pth or .npz)")
    parser.add_argument("--arch", default="unet_s",
                        choices=ARCHS)
    parser.add_argument("--classes", type=int, default=3)
    parser.add_argument("--bilinear", action="store_true", default=False)
    parser.add_argument("--output", "-o", default=None,
                        help="Output path (default: <model>.pt2)")
    parser.add_argument("--static", action="store_true", default=False,
                        help="Export with fully static 1x512x512 shapes")
    parser.add_argument("--format", default=None, choices=["pt2", "onnx", "both", "stablehlo"],
                        help="Artifact format (default: inferred from the -o extension, "
                             "else pt2)")
    parser.add_argument("--int8", action="store_true", default=False,
                        help="Export the int8 program instead (static --int8-hw, dynamic "
                             "batch); needs --int8-scales or --calib")
    parser.add_argument("--int8-scales", default=None, metavar="JSON",
                        help="Activation-scale calibration JSON (Predictor.save_calibration, "
                             "predict --int8-scales, either package)")
    parser.add_argument("--calib", default=None, metavar="PATH",
                        help="Image file or directory to calibrate the int8 scales from")
    parser.add_argument("--int8-hw", type=int, nargs=2, default=(512, 512),
                        metavar=("H", "W"), help="Static spatial shape of the int8 program")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; fails without a card) or cpu: where the program "
                             "is traced, holds its weights and serves")
    args = parser.parse_args(argv)
    if args.format == "stablehlo":
        parser.error("--format stablehlo: StableHLO is the JAX package's artifact (its "
                     "umics-export); the PyTorch package exports .pt2 programs and ONNX")
    if args.int8 and args.arch in INT8_NOT_PORTED:
        parser.error(f"--arch {args.arch} --int8: the int8 program of {args.arch} is not "
                     "ported to the PyTorch package yet; export it in float, or use the JAX "
                     "package's umics-export")
    if args.format is None:
        args.format = "onnx" if (args.output or "").endswith(".onnx") else "pt2"
    return args


def _calibration_batch(path: str, div: int):
    """Up to 4 images from ``path`` (a file or a directory), cut to
    multiples of ``div`` and to their common size: (n, H, W, 1) float32."""
    import numpy as np
    from PIL import Image

    from ..data.dataset import BasicDataset
    from ..engine.predict import collect_image_files

    files = (collect_image_files(path) if os.path.isdir(path) else [path])[:4]
    if not files:
        return None
    imgs = []
    for fp in files:
        a = BasicDataset.preprocess(None, Image.open(fp).convert("L"), scale=1, is_mask=False)
        imgs.append(a[:a.shape[0] // div * div, :a.shape[1] // div * div])
    h, w = min(a.shape[0] for a in imgs), min(a.shape[1] for a in imgs)
    return np.stack([a[:h, :w] for a in imgs])


def _export_int8(args, model, base: str) -> int:
    import numpy as np
    import torch

    from ..engine.export import export_program_int8, load_exported
    from ..engine.predict import Predictor
    from ..models.quantize import apply_int8

    if args.format != "pt2":
        logging.error("--int8 exports a .pt2 program only (no int8 ONNX path)")
        return 1
    predictor = Predictor(model, device=args.device, quantize=True)
    if args.int8_scales and os.path.exists(args.int8_scales):
        predictor.load_calibration(args.int8_scales)
        logging.info("Loaded int8 calibration from %s", args.int8_scales)
    elif args.calib:
        batch = _calibration_batch(args.calib, model.hw_divisor)
        if batch is None:
            logging.error("No calibration images under %s", args.calib)
            return 1
        predictor.calibrate(batch)
        if args.int8_scales:  # saved for reuse, as the predict CLI does
            predictor.save_calibration(args.int8_scales)
    else:
        logging.error("--int8 needs --int8-scales JSON or --calib images")
        return 1
    data = export_program_int8(model, predictor._qparams, example_hw=tuple(args.int8_hw))
    out = args.output or base + ".int8.pt2"
    with open(out, "wb") as f:
        f.write(data)
    logging.info("Exported %d bytes of int8 program (static %dx%d, dynamic batch) to %s",
                 len(data), *args.int8_hw, out)
    # sanity: the loaded program must equal the live int8 forward
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, *args.int8_hw, model.n_channels), np.float32)).to(predictor.device)
    with torch.no_grad():
        got = load_exported(data).module()(x)
    want = apply_int8(predictor._qparams, x, predictor.compute_dtype)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if agree == 1.0:
        logging.info("int8 program sanity forward passed (argmax identical to live int8).")
        return 0
    logging.error("int8 sanity forward FAILED: argmax agreement %.5f", agree)
    return 1


def main(argv=None) -> int:
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")

    import numpy as np
    import torch

    from ..engine.checkpoint import load_weights
    from ..models.unet import get_model

    state_dict, _ = load_weights(args.model, bilinear=args.bilinear,
                                 use_attention=args.arch == "unet_sa")
    compute_dtype = torch.bfloat16 if args.device.startswith("cuda") else None
    model = get_model(args.arch, n_channels=1, n_classes=args.classes, bilinear=args.bilinear,
                      compute_dtype=compute_dtype)
    model.load_state_dict(state_dict)
    model.eval()
    base = os.path.splitext(args.output or args.model)[0]

    if args.int8:
        return _export_int8(args, model, base)

    ok = True
    if args.format in ("pt2", "both"):
        from ..engine.export import export_program, sanity_check

        data = export_program(model, dynamic_batch=not args.static,
                              dynamic_hw=not args.static, device=args.device)
        out = args.output if (args.output and args.format == "pt2") else base + ".pt2"
        with open(out, "wb") as f:
            f.write(data)
        logging.info("Exported %d bytes of .pt2 program to %s", len(data), out)
        hw = (512, 512) if args.static else (128, 128)
        if sanity_check(data, model, hw=hw, device=args.device):
            logging.info(".pt2 sanity forward passed.")
        else:
            logging.error(".pt2 sanity forward FAILED.")
            ok = False

    if args.format in ("onnx", "both"):
        from ..engine.export import logits_close
        from ..engine.onnx_export import export_onnx, run_with_torch

        out = args.output if (args.output and args.format == "onnx") else base + ".onnx"
        data = export_onnx(model, out)
        logging.info("Exported %d bytes of ONNX (opset 11, dynamic axes) to %s",
                     len(data), out)
        # sanity: the serialized graph (torch-backed interpreter, f32 on the
        # CPU) against the live f32 forward
        x = np.random.default_rng(0).random((1, 1, 128, 128), np.float32)
        got = run_with_torch(data, x)
        with torch.no_grad():
            ref = get_model(args.arch, n_channels=1, n_classes=args.classes,
                            bilinear=args.bilinear)
            ref.load_state_dict(state_dict)
            want = ref.eval()(torch.from_numpy(x.transpose(0, 2, 3, 1)))
        want = want.numpy().transpose(0, 3, 1, 2)
        if logits_close(got, want, "ONNX sanity forward", class_axis=1):
            logging.info("ONNX sanity forward passed.")
        else:
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
