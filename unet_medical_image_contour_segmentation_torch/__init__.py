"""PyTorch/CUDA port of the UNet contour-segmentation system, for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports none
of it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Hand-written Hopper kernels live in ``kernels/`` (Python
wrappers) and ``csrc/`` (CUDA sources, built with nvcc on first use).
"""

from .device import exact_f32, resolve_device

__version__ = "0.1.0"

__all__ = ["exact_f32", "resolve_device", "__version__"]
