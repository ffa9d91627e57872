"""The alternate RAW preprocessing path: uint16 -> [0, 1] float .npy, long side 512.

The port's copy of the JAX package's ``pipeline/raw_normalize.py`` (not a
stage of ``seg_main``; kept for the same capability).  The nearest-neighbour
scaling is one vectorised gather with the reference's index rule
``src = min(int(dst / scale), orig - 1)``.  ``channel_order`` is accepted and
unused, as in the reference.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

__all__ = ["RawNormalizer", "nearest_resize_reference", "main"]

log = logging.getLogger(__name__)


def nearest_resize_reference(img: np.ndarray, new_h: int, new_w: int, scale: float) -> np.ndarray:
    """The reference's nearest-neighbour loop as one gather."""
    h, w = img.shape
    src_y = np.minimum((np.arange(new_h) / scale).astype(np.int64), h - 1)
    src_x = np.minimum((np.arange(new_w) / scale).astype(np.int64), w - 1)
    return img[src_y[:, None], src_x[None, :]]


class RawNormalizer:
    def __init__(self, input_path: str, output_path: Optional[str] = None, width: int = 0,
                 height: int = 0, bit_depth: int = 16, channel_order: str = "RGGB",
                 target_size: int = 512):
        self.input_path = Path(input_path)
        self.output_path = Path(output_path) if output_path else (
            self.input_path.parent if self.input_path.is_file() else self.input_path)
        self.width = width
        self.height = height
        self.bit_depth = bit_depth
        self.channel_order = channel_order
        self.target_size = target_size
        self.original_sizes: Dict[str, Dict[str, int]] = {}

    def _read_raw_file(self, raw_path: Path) -> np.ndarray:
        with open(raw_path, "rb") as f:
            data = f.read()
        return np.frombuffer(data, dtype="<u2").reshape((self.height, self.width))

    def _process_single_raw(self, raw_path: Path) -> bool:
        try:
            raw = self._read_raw_file(raw_path)
            h, w = raw.shape
            self.original_sizes[raw_path.name] = {"width": w, "height": h}
            normalized = raw.astype(np.float32) / (2**self.bit_depth - 1)
            if w >= h:
                scale = self.target_size / w
                new_w, new_h = self.target_size, int(h * scale)
            else:
                scale = self.target_size / h
                new_h, new_w = self.target_size, int(w * scale)
            scaled = nearest_resize_reference(normalized, new_h, new_w, scale)
            np.save(self.output_path / f"{raw_path.stem}.npy", scaled)
            return True
        except Exception:  # one bad file must not stop the batch: logged, counted
            log.exception("Failed to process %s", raw_path.name)
            return False

    def normalize(self) -> Dict[str, int]:
        self.output_path.mkdir(parents=True, exist_ok=True)
        if self.input_path.is_file():
            files = ([self.input_path] if self.input_path.suffix.lower() in (".raw", ".data")
                     else [])
        else:
            files = sorted(p for p in self.input_path.iterdir()
                           if p.suffix.lower() in (".raw", ".data"))
        if not files:
            log.warning("No RAW files found at %s", self.input_path)
            return {"processed": 0, "failed": 0, "total": 0}

        ok = sum(self._process_single_raw(p) for p in files)
        json_path = (self.output_path / f"{self.input_path.stem}_sizes.json"
                     if self.input_path.is_file()
                     else self.output_path / "original_sizes.json")
        with open(json_path, "w", encoding="utf-8") as f:
            json.dump(self.original_sizes, f, ensure_ascii=False, indent=2)
        return {"processed": ok, "failed": len(files) - ok, "total": len(files)}


def main(argv=None):
    """CLI: normalise a RAW file or directory to .npy."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(description="Normalize RAW to [0,1] .npy, long side 512")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", "-o")
    parser.add_argument("--width", "-w", type=int, required=True)
    parser.add_argument("--height", type=int, required=True)
    parser.add_argument("--bit-depth", type=int, default=16)
    parser.add_argument("--channel-order", default="RGGB")
    parser.add_argument("--target-size", type=int, default=512)
    args = parser.parse_args(argv)
    RawNormalizer(args.input, args.output, width=args.width, height=args.height,
                  bit_depth=args.bit_depth, channel_order=args.channel_order,
                  target_size=args.target_size).normalize()


if __name__ == "__main__":
    main()
