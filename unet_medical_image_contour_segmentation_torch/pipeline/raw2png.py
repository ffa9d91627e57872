"""Stage 1: 16-bit RAW -> windowed 8-bit PNG.

The port's copy of the JAX package's ``pipeline/raw2png.py``.  Little-endian
uint16 frames are window/level mapped (clip to [center - width/2, center +
width/2], linear to 0..255) and written as grayscale PNG.  The JAX module
writes with imageio; this one writes the same pixels with PIL, imported where
it is used, so the package imports on machines without it.  Files convert
in a thread pool: the stage is I/O bound.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

__all__ = ["RawToPngConverter", "apply_windowing", "read_16bit_raw", "main"]

log = logging.getLogger(__name__)


def read_16bit_raw(raw_path: str, width: int, height: int) -> np.ndarray:
    """Read a little-endian 16-bit RAW frame as (H, W) uint16."""
    file_size = os.path.getsize(raw_path)
    expected = width * height * 2
    if file_size != expected:
        log.warning("File size mismatch: actual %d bytes, expected %d (%dx%d)",
                    file_size, expected, width, height)
    with open(raw_path, "rb") as f:
        data = f.read()
    return np.frombuffer(data, dtype="<u2").reshape((height, width))


def apply_windowing(img: np.ndarray, window_length: int, window_width: int) -> np.ndarray:
    """Window/level map to uint8."""
    window_min = window_length - window_width // 2
    window_max = window_length + window_width // 2
    clipped = np.clip(img, window_min, window_max)
    return ((clipped - window_min) / (window_max - window_min) * 255).astype(np.uint8)


class RawToPngConverter:
    """Single-file or directory batch RAW->PNG conversion."""

    def __init__(self, input_path: str, output_dir: Optional[str] = None,
                 width: Optional[int] = None, height: Optional[int] = None,
                 window_length: Optional[int] = None, window_width: Optional[int] = None,
                 num_workers: int = 8):
        self.input_path = input_path
        self.output_dir = output_dir or os.path.dirname(input_path)
        self.width = width
        self.height = height
        self.window_length = window_length
        self.window_width = window_width
        self.num_workers = num_workers

    def convert_single_file(self, raw_path: str) -> bool:
        from PIL import Image

        filename = os.path.basename(raw_path)
        try:
            img16 = read_16bit_raw(raw_path, self.width, self.height)
            img8 = apply_windowing(img16, self.window_length, self.window_width)
            os.makedirs(self.output_dir, exist_ok=True)
            out = os.path.join(self.output_dir, os.path.splitext(filename)[0] + ".png")
            Image.fromarray(img8).save(out, "PNG")
            log.info("%s converted -> %s", filename, out)
            return True
        except Exception:  # one bad file must not stop the batch: logged, counted
            log.exception("%s conversion failed", filename)
            return False

    def convert(self) -> Tuple[int, int]:
        """Returns (converted, failed)."""
        if os.path.isfile(self.input_path) and self.input_path.lower().endswith(".raw"):
            files = [self.input_path]
        elif os.path.isdir(self.input_path):
            files = [os.path.join(self.input_path, f) for f in os.listdir(self.input_path)
                     if os.path.isfile(os.path.join(self.input_path, f))
                     and f.lower().endswith(".raw")]
            if not files:
                log.warning("No RAW files found in %s", self.input_path)
                return 0, 0
        else:
            log.error("Invalid input path: %s", self.input_path)
            return 0, 0

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            results = list(ex.map(self.convert_single_file, files))
        ok = sum(results)
        return ok, len(results) - ok


def main(argv=None):
    """CLI: convert a RAW file or directory to PNG."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(description="Convert 16-bit RAW images to PNG")
    parser.add_argument("--input", required=True, help="RAW file or directory")
    parser.add_argument("--output", default=None)
    parser.add_argument("--width", "-w", type=int, required=True)
    parser.add_argument("--height", type=int, required=True)
    parser.add_argument("--window-width", "-ww", type=int, required=True)
    parser.add_argument("--window-length", "-wl", type=int, required=True)
    args = parser.parse_args(argv)

    if not os.path.exists(args.input):
        log.error("Input path does not exist: %s", args.input)
        raise SystemExit(1)
    RawToPngConverter(input_path=args.input, output_dir=args.output, width=args.width,
                      height=args.height, window_width=args.window_width,
                      window_length=args.window_length).convert()


if __name__ == "__main__":
    main()
