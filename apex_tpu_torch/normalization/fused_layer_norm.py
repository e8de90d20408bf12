"""FusedLayerNorm: layer norm over the trailing dims through the kernel.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``.  There is no
tuning-profile lookup: every call goes through
:class:`apex_tpu_torch.ops.layer_norm.LayerNormFunction`, whose forward and
backward launch the CUDA kernels for a CUDA tensor and take the plain
versions for a CPU one.  The gradients are those of the JAX package's XLA
VJP (``fused_layer_norm.py:80-97``): dx from the saved mean/invvar, dw and
db as fp32 column sums.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..ops.layer_norm import LayerNormFunction
from ..utils.device import resolve_device

__all__ = ["fused_layer_norm_affine", "fused_layer_norm", "FusedLayerNorm"]

Shape = Union[int, Sequence[int]]


def _norm_shape(normalized_shape: Shape):
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


def fused_layer_norm_affine(x: torch.Tensor, weight, bias,
                            normalized_shape: Shape, eps: float = 1e-5
                            ) -> torch.Tensor:
    """Layer norm of ``x`` over ``normalized_shape`` (its trailing dims)
    with an optional affine; ``weight``/``bias`` may be None."""
    shape = _norm_shape(normalized_shape)
    k = len(shape)
    if tuple(x.shape[-k:]) != shape:
        raise ValueError(f"normalized_shape {shape} does not match trailing "
                         f"dims of {tuple(x.shape)}")
    h = 1
    for s in shape:
        h *= s
    w = weight.reshape(h) if weight is not None else None
    b = bias.reshape(h) if bias is not None else None
    out = LayerNormFunction.apply(x.contiguous().reshape(-1, h), w, b, eps)
    return out.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5) -> torch.Tensor:
    """Non-affine variant."""
    return fused_layer_norm_affine(x, None, None, normalized_shape, eps)


class FusedLayerNorm(nn.Module):
    """``apex.normalization.FusedLayerNorm`` as an ``nn.Module`` holding
    ``weight`` (ones) and ``bias`` (zeros) when ``elementwise_affine``."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, *, device="cuda"):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            dev = resolve_device(device)
            self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                                  device=dev))
            self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                                 device=dev))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm_affine(x, self.weight, self.bias,
                                       self.normalized_shape, self.eps)
