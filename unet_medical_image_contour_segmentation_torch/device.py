"""Device selection: the port runs on the card unless asked for the CPU."""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

__all__ = ["resolve_device", "exact_f32"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` by default; raises when a CUDA device is asked for and there
    is no card.  Never falls back to the CPU: pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """Full-f32 convolutions and matrix products inside the block.

    cuDNN runs f32 convolutions in TF32 by default (about three decimal
    digits); a caller that compares f32 results turns that off here.
    """
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
