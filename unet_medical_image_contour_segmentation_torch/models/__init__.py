"""UNet modules, BN folding and weight interchange with the JAX package."""
