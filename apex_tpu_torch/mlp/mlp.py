"""MLP: a multi-layer perceptron whose layers each run as one fused
GEMM + bias + activation.

Counterpart of ``apex_tpu/mlp/mlp.py``.  The JAX package has two routes,
an XLA chain (``mlp_function``) and the Pallas kernel a layer
(``use_pallas=True``), chosen by a tuning profile; both compute each layer
as act(h @ w + b) in fp32, cast to the input's dtype.  The port has one:
every :meth:`MLP.apply` goes through
:func:`~apex_tpu_torch.ops.fused_mlp.dense_act` whatever ``use_pallas``
says (kept for the signature): the kernel for CUDA tensors, its plain
version for CPU tensors.  There is no tuning-profile lookup, as in
:mod:`apex_tpu_torch.normalization`.  Weights keep the JAX layout
(in, out).  The activation follows every layer, the last included.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..amp import amp as _amp
from ..ops.fused_mlp import ACTIVATIONS, mlp_pallas
from ..utils.device import from_numpy, resolve_device

__all__ = ["MLP", "mlp_function", "mlp_params_from_jax"]

#: the chained forward, an amp half function as the JAX package's
#: ``mlp_function`` and ``_mlp_pallas_function``: while amp O1 / O4 casts
#: are on, x is cast to the low-precision type (the weights and biases
#: are not, as in the JAX package), else it is :func:`mlp_pallas` itself
mlp_function = _amp.half_function(mlp_pallas)


class MLP:
    """``sizes = [in, h1, ..., out]``; ``activation`` is "none", "relu"
    or "sigmoid" (default "relu" if ``relu`` else "none")."""

    def __init__(self, mlp_sizes: Sequence[int], bias=True, relu=True,
                 activation=None, use_pallas=None):
        if activation is None:
            activation = "relu" if relu else "none"
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation} not supported")
        self.sizes = list(mlp_sizes)
        self.bias = bias
        self.activation = activation
        self.use_pallas = use_pallas

    def init(self, generator: torch.Generator, device=None):
        """{"weights": [(in, out)...], "biases": [(out,) or None...]},
        fp32, drawn on the CPU from ``generator`` (so a seed gives the same
        weights on every device), then moved to ``device`` (default
        ``"cuda"``).  Weights are Xavier-normal, N(0, 2 / (fan_in +
        fan_out)), biases N(0, 1 / fan_out), as the JAX package's."""
        dev = resolve_device(device)
        params = {"weights": [], "biases": []}
        for fan_in, fan_out in zip(self.sizes[:-1], self.sizes[1:]):
            w_std = (2.0 / (fan_in + fan_out)) ** 0.5
            w = torch.randn(fan_in, fan_out, generator=generator) * w_std
            params["weights"].append(w.to(dev))
            b = None
            if self.bias:
                b = torch.randn(fan_out, generator=generator) \
                    * (1.0 / fan_out) ** 0.5
                b = b.to(dev)
            params["biases"].append(b)
        return params

    def apply(self, params, x: torch.Tensor) -> torch.Tensor:
        return mlp_function(x, params["weights"], params["biases"],
                            self.activation)

    __call__ = apply


def mlp_params_from_jax(params, device=None):
    """The JAX package's MLP parameters (numpy arrays, or anything
    ``np.asarray`` takes; biases may be None) -> the port's, same layout
    and values, on ``device`` (default ``"cuda"``)."""
    return from_numpy(params, device)
