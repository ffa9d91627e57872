"""UNet modules, BN folding and weight interchange with the JAX package."""

from .unet import MODEL_REGISTRY, UNet, get_model, unet, unet_s, unet_sa, unet_t

__all__ = [
    "MODEL_REGISTRY",
    "UNet",
    "get_model",
    "unet",
    "unet_s",
    "unet_sa",
    "unet_t",
]
