"""Host-side utilities."""

from .viz import plot_img_and_mask

__all__ = ["plot_img_and_mask"]
