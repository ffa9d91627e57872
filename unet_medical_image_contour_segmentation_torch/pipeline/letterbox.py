"""Stages 2 and 4: the 512x512 letterbox and its inverse.

The port's copy of the JAX package's ``pipeline/letterbox.py``.  Normalise:
grayscale 'L', aspect-preserving LANCZOS resize with the long side to 512,
centred paste on a black 512x512 canvas, each file's original size recorded
in ``original_sizes.json``.  Denormalise: the scale and padding again from
the recorded size, crop the black bars, LANCZOS back to the original size.
PIL's LANCZOS is kept for bit parity; PIL is imported where it is used.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = [
    "letterbox_geometry",
    "normalize_image",
    "denormalize_image",
    "PngNormalizer",
    "PngDenormalizer",
    "main_normalize",
    "main_denormalize",
]

log = logging.getLogger(__name__)


def letterbox_geometry(orig_w: int, orig_h: int, target: int = 512) -> Tuple[int, int, int, int]:
    """(new_w, new_h, pad_x, pad_y) of the centred letterbox."""
    if orig_w >= orig_h:
        new_w = target
        new_h = int(orig_h * (target / orig_w))
    else:
        new_h = target
        new_w = int(orig_w * (target / orig_h))
    return new_w, new_h, (target - new_w) // 2, (target - new_h) // 2


def normalize_image(img, target: int = 512):
    """Grayscale + LANCZOS long-side resize + centred black letterbox."""
    from PIL import Image

    if img.mode != "L":
        img = img.convert("L")
    w, h = img.size
    new_w, new_h, pad_x, pad_y = letterbox_geometry(w, h, target)
    resized = img.resize((new_w, new_h), resample=Image.LANCZOS)
    canvas = Image.new("L", (target, target), 0)
    canvas.paste(resized, (pad_x, pad_y))
    return canvas


def denormalize_image(img, orig_w: int, orig_h: int, target: int = 512):
    """Crop the letterbox padding and LANCZOS back to the original size."""
    from PIL import Image

    new_w, new_h, pad_x, pad_y = letterbox_geometry(orig_w, orig_h, target)
    cropped = img.crop((pad_x, pad_y, pad_x + new_w, pad_y + new_h))
    return cropped.resize((orig_w, orig_h), resample=Image.LANCZOS)


def _out_dir(input_path: Path, output_path: Optional[str]) -> Path:
    if output_path:
        return Path(output_path)
    return input_path.parent if input_path.is_file() else input_path


def _pngs(input_path: Path):
    if input_path.is_file():
        return [input_path] if input_path.suffix.lower() == ".png" else []
    return sorted(input_path.glob("*.png"))


class PngNormalizer:
    """Directory/single-file letterbox normaliser writing original_sizes.json."""

    def __init__(self, input_path: str, output_path: Optional[str] = None,
                 target_size: int = 512):
        self.input_path = Path(input_path)
        self.output_path = _out_dir(self.input_path, output_path)
        self.target_size = target_size
        self.original_sizes: Dict[str, Dict[str, int]] = {}

    def _json_path(self) -> Path:
        if self.input_path.is_file():
            return self.output_path / f"{self.input_path.stem}_sizes.json"
        return self.output_path / "original_sizes.json"

    def normalize(self) -> Dict[str, int]:
        from PIL import Image

        self.output_path.mkdir(parents=True, exist_ok=True)
        files = _pngs(self.input_path)
        if not files:
            log.warning("No PNG images found at %s", self.input_path)
            return {"processed": 0, "failed": 0, "total": 0}

        ok = 0
        for p in files:
            try:
                with Image.open(p) as img:
                    w, h = img.size
                    self.original_sizes[p.name] = {"width": w, "height": h}
                    out = normalize_image(img, self.target_size)
                    out.save(self.output_path / p.name, "PNG", compress_level=1)
                ok += 1
            except Exception:  # one bad file must not stop the batch: logged, counted
                log.exception("Failed to normalize %s", p.name)

        with open(self._json_path(), "w", encoding="utf-8") as f:
            json.dump(self.original_sizes, f, ensure_ascii=False, indent=2)
        return {"processed": ok, "failed": len(files) - ok, "total": len(files)}


class PngDenormalizer:
    """Inverse letterbox from the recorded original sizes."""

    def __init__(self, input_path: str, output_path: Optional[str] = None,
                 original_sizes_json: Optional[str] = None, target_size: int = 512):
        self.input_path = Path(input_path)
        self.output_path = _out_dir(self.input_path, output_path)
        if original_sizes_json:
            self.original_sizes_json = Path(original_sizes_json)
        elif self.input_path.is_file():
            self.original_sizes_json = (self.input_path.parent
                                        / f"{self.input_path.stem}_sizes.json")
        else:
            self.original_sizes_json = self.input_path / "original_sizes.json"
        self.target_size = target_size
        self.original_sizes: Dict[str, Dict[str, int]] = {}

    def denormalize(self) -> Dict[str, int]:
        from PIL import Image

        try:
            with open(self.original_sizes_json, "r", encoding="utf-8") as f:
                self.original_sizes = json.load(f)
        except (OSError, ValueError):
            log.exception("Failed to load original sizes JSON %s", self.original_sizes_json)
            return {"processed": 0, "failed": 0, "total": 0}

        self.output_path.mkdir(parents=True, exist_ok=True)
        files = _pngs(self.input_path)
        if not files:
            log.warning("No PNG images found at %s", self.input_path)
            return {"processed": 0, "failed": 0, "total": 0}

        ok = 0
        for p in files:
            if p.name not in self.original_sizes:
                log.warning("No original size recorded for %s, skipping", p.name)
                continue
            try:
                size = self.original_sizes[p.name]
                with Image.open(p) as img:
                    out = denormalize_image(img, size["width"], size["height"],
                                            self.target_size)
                    out.save(self.output_path / p.name, "PNG", compress_level=1)
                ok += 1
            except Exception:  # one bad file must not stop the batch: logged, counted
                log.exception("Failed to denormalize %s", p.name)
        return {"processed": ok, "failed": len(files) - ok, "total": len(files)}


def main_normalize(argv=None):
    """CLI: letterbox PNGs to 512x512."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(description="Letterbox PNGs to 512x512")
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", "-o")
    parser.add_argument("--size", "-s", type=int, default=512)
    args = parser.parse_args(argv)
    PngNormalizer(args.input, args.output, target_size=args.size).normalize()


def main_denormalize(argv=None):
    """CLI: invert the 512x512 letterbox."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(description="Invert the 512x512 letterbox")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output")
    parser.add_argument("-j", "--json")
    parser.add_argument("-s", "--size", type=int, default=512)
    args = parser.parse_args(argv)
    PngDenormalizer(args.input, args.output, args.json, target_size=args.size).denormalize()
