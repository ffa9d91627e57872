"""PyTorch/CUDA port of the UNet contour-segmentation system, for NVIDIA Hopper.

It sits beside the JAX package, which stays the reference, and imports none
of it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``.  Hand-written Hopper kernels live in ``kernels/`` (Python
wrappers) and ``csrc/`` (CUDA sources, built with nvcc on first use, see
``utils/compile_cache.py``).  The top level exports what the JAX package's
does (the UNet family) and the port's device helpers.
"""

from .device import exact_f32, resolve_device
from .models.unet import UNet, get_model, unet, unet_s, unet_sa, unet_t

__version__ = "0.1.0"

__all__ = ["UNet", "get_model", "unet", "unet_s", "unet_sa", "unet_t", "__version__",
           "exact_f32", "resolve_device"]
