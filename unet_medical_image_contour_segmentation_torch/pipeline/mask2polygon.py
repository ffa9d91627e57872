"""Stage 5: mask PNG -> labelme-style contour JSON + red overlay PNG.

The port's copy of the JAX package's ``pipeline/mask2polygon.py``.  Threshold
> 127, external contours with CHAIN_APPROX_SIMPLE, written as
``{version: "1.0.2.799", shapes: [{label: 1, points, shape_type: "polygon"}]}``
with the original image size from ``original_sizes.json``; the overlay draws
the contours in red (BGR 0, 0, 255), 4 px wide, on the original PNG found by
the same three-candidate search.  cv2 is imported where it is used.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

__all__ = ["MaskProcessor", "mask_to_polygons", "build_labelme_json", "main"]

log = logging.getLogger(__name__)


def mask_to_polygons(mask: np.ndarray, threshold: int = 127) -> List[np.ndarray]:
    """External contours of mask > threshold, each (N, 2) int points."""
    import cv2

    _, binary = cv2.threshold(mask, threshold, 255, cv2.THRESH_BINARY)
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return [c.squeeze(axis=1) for c in contours]


def build_labelme_json(base_name: str, contours: List[np.ndarray], width: int,
                       height: int) -> dict:
    return {
        "version": "1.0.2.799",
        "imagePath": base_name,
        "imageData": None,
        "flags": {},
        "shapes": [
            {
                "label": 1,
                "labelIndex": 0,
                "points": c.tolist(),
                "shape_type": "polygon",
                "description": "",
                "mask": None,
                "group_id": None,
                "flags": {},
            }
            for c in contours
        ],
        "imageWidth": width,
        "imageHeight": height,
    }


class MaskProcessor:
    """Mask -> JSON + overlay for a file or a directory."""

    def __init__(self, input_path: str, output_path: Optional[str] = None,
                 sizes_json_path: Optional[str] = None):
        self.input_path = Path(input_path)
        if output_path:
            self.output_path = Path(output_path)
        elif self.input_path.is_file():
            self.output_path = self.input_path.parent
        else:
            self.output_path = self.input_path
        self.sizes_json_path = Path(sizes_json_path) if sizes_json_path else None
        if not self.sizes_json_path or not self.sizes_json_path.exists():
            raise FileNotFoundError(f"sizes JSON not found: {self.sizes_json_path}")
        with open(self.sizes_json_path, "r", encoding="utf-8") as f:
            self.sizes_data: Dict[str, Dict[str, int]] = json.load(f)

    def _find_original_png(self, base_name: str) -> Optional[Path]:
        candidates = [
            self.output_path / f"{base_name}.png",
            self.output_path.parent / "1_raw_png" / f"{base_name}.png",
            self.input_path.parent / f"{base_name}.png",
        ]
        for c in candidates:
            if c.exists() and c.suffix.lower() == ".png":
                return c
        return None

    def _create_overlay(self, contours: List[np.ndarray], base_name: str) -> None:
        import cv2

        original = self._find_original_png(base_name)
        if not original:
            log.warning("No original PNG found, skipping overlay for %s.png", base_name)
            return
        img = cv2.imread(str(original))
        if img is None:
            log.warning("Could not read original PNG %s", original)
            return
        cv2.drawContours(img, [c[:, np.newaxis, :] for c in contours], -1, (0, 0, 255), 4)
        cv2.imwrite(str(self.output_path / f"{base_name}_contour_overlay.png"), img)

    def process_mask(self, mask_path: Path) -> bool:
        import cv2

        try:
            name = mask_path.name
            if name not in self.sizes_data:
                raise KeyError(f"no size info for {name} in sizes JSON")
            size = self.sizes_data[name]
            mask = cv2.imread(str(mask_path), cv2.IMREAD_GRAYSCALE)
            if mask is None:
                raise ValueError(f"cannot read mask {mask_path}")
            contours = mask_to_polygons(mask)
            if not contours:
                log.warning("No contours detected in %s", name)
                return False
            base = mask_path.stem
            data = build_labelme_json(base, contours, size["width"], size["height"])
            with open(self.output_path / f"{base}.json", "w", encoding="utf-8") as f:
                json.dump(data, f, ensure_ascii=False, indent=2)
            self._create_overlay(contours, base)
            return True
        except Exception:  # one bad mask must not stop the batch: logged, counted
            log.exception("Failed to process %s", mask_path.name)
            return False

    def process(self) -> Dict[str, int]:
        if self.input_path.is_file():
            files = [self.input_path] if self.input_path.suffix.lower() == ".png" else []
        else:
            files = sorted(self.input_path.glob("*.png"))
        if not files:
            log.warning("No PNG masks found at %s", self.input_path)
            return {"total": 0, "success": 0, "failed": 0}
        self.output_path.mkdir(parents=True, exist_ok=True)
        ok = sum(self.process_mask(p) for p in files)
        return {"total": len(files), "success": ok, "failed": len(files) - ok}


def main(argv=None):
    """CLI: masks to contour JSON + overlay."""
    import argparse

    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    parser = argparse.ArgumentParser(description="Convert masks to contour JSON + overlay")
    parser.add_argument("-i", "--input", required=True)
    parser.add_argument("-o", "--output")
    parser.add_argument("-j", "--json", required=True, help="original sizes JSON path")
    args = parser.parse_args(argv)
    try:
        MaskProcessor(args.input, args.output, args.json).process()
    except Exception as e:  # the CLI's boundary: report and exit 1
        log.error("Processing failed: %s", e, exc_info=True)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
