"""Host-side dataset, preprocessing and the batch pipeline to the card."""

from .dataset import BasicDataset, CarvanaDataset, load_image, unique_mask_values
from .loader import DataLoader, prefetch_to_device

__all__ = [
    "BasicDataset",
    "CarvanaDataset",
    "load_image",
    "unique_mask_values",
    "DataLoader",
    "prefetch_to_device",
]
