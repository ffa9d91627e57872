"""Runtime version report, the port's counterpart of the JAX package's
``utils/version_info.py`` (the reference's ``utils/torch_version.py``)."""

from __future__ import annotations

import numpy
import torch

__all__ = ["version_info"]


def version_info() -> dict:
    """The package, torch, CUDA and cuDNN versions and the devices (the CPU
    only, without a card)."""
    from .. import __version__

    cuda = torch.cuda.is_available()
    return {
        "framework": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version() if cuda else None,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
        "numpy": numpy.__version__,
    }


if __name__ == "__main__":
    for k, v in version_info().items():
        print(f"{k}: {v}")
