"""MLP: a multi-layer perceptron, each layer act(h @ w + b) in fp32 cast to
the input's dtype.

Counterpart of ``apex_tpu/mlp/mlp.py``.  Two routes, as in the JAX
package, chosen by ``use_pallas`` when the MLP is built:

- ``True``: one :func:`~apex_tpu_torch.ops.fused_mlp.dense_act` a layer,
  the kernel for CUDA tensors and its plain version for CPU tensors
  (:data:`mlp_function`'s route);
- ``False``: the counterpart of the JAX XLA chain (``mlp_function``
  there): ``x @ w + b``, the activation, in fp32 and cast back, in plain
  PyTorch with autograd's gradients, launching no kernel
  (:data:`mlp_plain_function`).

``None`` (the default) reads the tuning profile's ``mlp_use_pallas`` (on
the card only, :func:`~apex_tpu_torch.utils.tuning.get_on_gpu`), and
without one takes the kernel: the JAX built-in is its XLA chain, the
port's is the kernel that replaces the TPU one.  Both routes are amp half
functions, so O1 / O4 casts reach them alike.  Weights keep the JAX layout
(in, out).  The activation follows every layer, the last included.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..amp import amp as _amp
from ..ops.fused_mlp import (ACTIVATIONS, fused_dense_act_reference,
                             mlp_pallas)
from ..utils import tuning
from ..utils.device import from_numpy, resolve_device

__all__ = ["MLP", "mlp_function", "mlp_plain_function",
           "mlp_params_from_jax"]

#: the kernel route, an amp half function as the JAX package's
#: ``_mlp_pallas_function``: while amp O1 / O4 casts are on, x is cast to
#: the low-precision type (the weights and biases are not, as in the JAX
#: package), else it is :func:`mlp_pallas` itself
mlp_function = _amp.half_function(mlp_pallas)


def _mlp_plain(x, weights, biases, activation="relu"):
    """The JAX XLA chain: act(h @ w + b) in fp32, cast to x's dtype, a
    layer at a time."""
    h = x
    for w, b in zip(weights, biases):
        h = fused_dense_act_reference(h, w, b, activation)
    return h


#: the plain route, an amp half function as the JAX ``mlp_function``
mlp_plain_function = _amp.half_function(_mlp_plain)


class MLP:
    """``sizes = [in, h1, ..., out]``; ``activation`` is "none", "relu"
    or "sigmoid" (default "relu" if ``relu`` else "none"); ``use_pallas``
    True the kernel, False the plain chain, None the tuning profile's
    ``mlp_use_pallas`` (the kernel without one), resolved here."""

    def __init__(self, mlp_sizes: Sequence[int], bias=True, relu=True,
                 activation=None, use_pallas=None):
        if activation is None:
            activation = "relu" if relu else "none"
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation {activation} not supported")
        self.sizes = list(mlp_sizes)
        self.bias = bias
        self.activation = activation
        if use_pallas is None:
            use_pallas = bool(tuning.get_on_gpu("mlp_use_pallas", True))
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
        fn = mlp_function if self.use_pallas else mlp_plain_function
        return fn(x, params["weights"], params["biases"], self.activation)

    __call__ = apply


def mlp_params_from_jax(params, device=None):
    """The JAX package's MLP parameters (numpy arrays, or anything
    ``np.asarray`` takes; biases may be None) -> the port's, same layout
    and values, on ``device`` (default ``"cuda"``)."""
    return from_numpy(params, device)
