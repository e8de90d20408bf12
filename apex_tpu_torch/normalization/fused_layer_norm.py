"""FusedLayerNorm: layer norm over the trailing dims.

Counterpart of ``apex_tpu/normalization/fused_layer_norm.py``.  Two routes,
chosen by ``use_pallas`` (the JAX keyword, kept so a profile or a caller
means the same thing under both packages):

- the kernels (``True``): :class:`apex_tpu_torch.ops.layer_norm.
  LayerNormFunction`, whose forward and backward launch the CUDA kernels
  for a CUDA tensor and take their plain versions for a CPU one;
- the plain route (``False``): the counterpart of the JAX package's XLA
  VJP (``fused_layer_norm.py:50-97``), the same function's plain versions
  (``LayerNormFunction``'s ``plain``): the forward in plain PyTorch and dx
  from the saved mean / invvar, launching no kernel.

``None`` (the default) reads the tuning profile's
``layer_norm_use_pallas`` (on the card only,
:func:`~apex_tpu_torch.utils.tuning.get_on_gpu`), and without one takes the
kernels.  The JAX built-in is its XLA route; the port's is the kernel, the
port's rule that a TPU kernel on the path becomes the card's kernel.
Either way dw and db are fp32 column sums and the gradients are those of
the JAX VJP.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from ..ops.layer_norm import LayerNormFunction
from ..utils import tuning
from ..utils.device import resolve_device

__all__ = ["fused_layer_norm_affine", "fused_layer_norm", "FusedLayerNorm"]

Shape = Union[int, Sequence[int]]


def _norm_shape(normalized_shape: Shape):
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


def _resolve_use_pallas(use_pallas) -> bool:
    """True / False as given; None: ``layer_norm_use_pallas`` (on the card
    only), else True, the kernels."""
    if use_pallas is None:
        return bool(tuning.get_on_gpu("layer_norm_use_pallas", True))
    return bool(use_pallas)


def fused_layer_norm_affine(x: torch.Tensor, weight, bias,
                            normalized_shape: Shape, eps: float = 1e-5, *,
                            use_pallas=None) -> torch.Tensor:
    """Layer norm of ``x`` over ``normalized_shape`` (its trailing dims)
    with an optional affine; ``weight``/``bias`` may be None.
    ``use_pallas``: True the kernels, False the plain route, None the
    tuning profile's choice (the kernels without one)."""
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
    out = LayerNormFunction.apply(x.contiguous().reshape(-1, h), w, b, eps,
                                  not _resolve_use_pallas(use_pallas))
    return out.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, normalized_shape: Shape,
                     eps: float = 1e-5, *, use_pallas=None) -> torch.Tensor:
    """Non-affine variant."""
    return fused_layer_norm_affine(x, None, None, normalized_shape, eps,
                                   use_pallas=use_pallas)


class FusedLayerNorm(nn.Module):
    """``apex.normalization.FusedLayerNorm`` as an ``nn.Module`` holding
    ``weight`` (ones) and ``bias`` (zeros) when ``elementwise_affine``;
    ``use_pallas`` as :func:`fused_layer_norm_affine`'s, read at each
    call."""

    def __init__(self, normalized_shape: Shape, eps: float = 1e-5,
                 elementwise_affine: bool = True, use_pallas=None, *,
                 device="cuda"):
        super().__init__()
        self.normalized_shape = _norm_shape(normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        self.use_pallas = use_pallas
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
                                       self.normalized_shape, self.eps,
                                       use_pallas=self.use_pallas)
