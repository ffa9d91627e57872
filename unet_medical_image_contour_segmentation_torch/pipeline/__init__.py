"""The host stages of the RAW -> contour-JSON pipeline and its driver; PIL and
cv2 are imported inside the functions that use them."""

from .letterbox import (
    PngDenormalizer,
    PngNormalizer,
    denormalize_image,
    letterbox_geometry,
    normalize_image,
)
from .mask2polygon import MaskProcessor, build_labelme_json, mask_to_polygons
from .post_process import postprocess_mask, remove_internal_regions
from .raw2png import RawToPngConverter, apply_windowing, read_16bit_raw
from .raw_normalize import RawNormalizer, nearest_resize_reference
from .seg_main import STAGES, create_work_dirs, run_pipeline

__all__ = [
    "PngDenormalizer",
    "PngNormalizer",
    "denormalize_image",
    "letterbox_geometry",
    "normalize_image",
    "MaskProcessor",
    "build_labelme_json",
    "mask_to_polygons",
    "postprocess_mask",
    "remove_internal_regions",
    "RawToPngConverter",
    "apply_windowing",
    "read_16bit_raw",
    "RawNormalizer",
    "nearest_resize_reference",
    "STAGES",
    "create_work_dirs",
    "run_pipeline",
]
