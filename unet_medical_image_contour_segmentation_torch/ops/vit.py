"""The ops the R50-ViT hybrid (TransUNet, ``models/transunet.py``) adds to
the port: attention, LayerNorm, GroupNorm and weight standardisation (its
GELU is ``F.gelu``, the exact one).

Activations are NHWC for the maps and (B, N, D) for the tokens.  The norms
are thin wrappers over PyTorch's, with the affine in the input's dtype.
GroupNorm takes the channels-last view of a NHWC map; PyTorch's CUDA
GroupNorm copies such a view to NCHW and its output back, two copies of
the map a call.

:func:`attention` is ``softmax(q kᵀ / sqrt(d)) v`` over (B, heads, N, d).
On a CUDA card, in bf16 or f16, it is ``F.scaled_dot_product_attention``
under one pinned backend, :data:`PINNED`; an f32 CUDA call takes the
memory-efficient backend (the fused kernels that take f32), and a CPU call
the math form.  ``attention.calls_by_backend`` counts the calls by the
backend that ran them.  ``group_norm.calls`` and ``standardize_weight.calls``
count theirs: the served forward runs no weight standardisation.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

__all__ = ["PINNED", "attention", "layer_norm", "group_norm", "standardize_weight"]

# the backend of every half-precision attention on the card: at (8 x 12
# heads, 1024, 64) bf16 on the H100, cuDNN's fused kernel took 0.067 ms a
# call against flash's 0.095 and the memory-efficient kernel's 0.207 (PERF.md)
PINNED = "cudnn"
_BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION, "cudnn": SDPBackend.CUDNN_ATTENTION,
             "efficient": SDPBackend.EFFICIENT_ATTENTION, "math": SDPBackend.MATH}
# StdConv2d's epsilon (TransUNet's vit_seg_modeling_resnet_skip.py)
_STD_EPS = 1e-5


def _backend(q: torch.Tensor) -> str:
    if q.device.type != "cuda":
        return "math"
    return PINNED if q.dtype in (torch.bfloat16, torch.float16) else "efficient"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q kᵀ / sqrt(d)) v`` of (B, heads, N, d) ``q``, ``k``, ``v`` ->
    (B, heads, N, d) in their dtype, on the backend of the module docstring."""
    name = _backend(q)
    attention.calls_by_backend[name] += 1
    with sdpa_kernel(_BACKENDS[name]):
        return F.scaled_dot_product_attention(q, k, v)


attention.calls_by_backend = Counter()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last dimension, the affine in x's dtype."""
    return F.layer_norm(x, x.shape[-1:], weight.to(x.dtype), bias.to(x.dtype), eps)


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """GroupNorm of a NHWC map over ``groups`` groups of its channels, the
    affine in x's dtype -> NHWC."""
    group_norm.calls += 1
    y = F.group_norm(x.permute(0, 3, 1, 2), groups, weight.to(x.dtype), bias.to(x.dtype), eps)
    return y.permute(0, 2, 3, 1)


group_norm.calls = 0


def standardize_weight(w: torch.Tensor) -> torch.Tensor:
    """StdConv2d's weight: an OIHW ``w`` standardised over (I, H, W) of each
    output channel by its mean and biased variance, ``(w - mean) /
    sqrt(var + 1e-5)``, in f32."""
    standardize_weight.calls += 1
    wf = w.float()
    var, mean = torch.var_mean(wf, dim=(1, 2, 3), keepdim=True, unbiased=False)
    return (wf - mean) / torch.sqrt(var + _STD_EPS)


standardize_weight.calls = 0
