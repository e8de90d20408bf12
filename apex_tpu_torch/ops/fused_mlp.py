"""Fused dense layer act(x @ w + b): the hand-written Hopper kernels, their
plain version and its autograd function.

Counterpart of ``apex_tpu/ops/fused_mlp.py``.  :func:`fused_dense_act`
launches a kernel of ``apex_tpu_torch/csrc/fused_mlp.cu`` for CUDA
tensors and takes :func:`fused_dense_act_reference` only for CPU tensors.
:func:`_route` picks the kernel from the inputs before the launch: fp32
the SIMT kernel; fp16 / bf16 the TMA + wgmma kernel where TMA can take the
operands (K and N multiples of 8, x and w 16-byte aligned), else the
mma.sync kernel.  A failed build or launch raises; nothing retries on
another route.  Weights keep the JAX layout, ``w`` (in, out), so ``x @
w``.  :class:`DenseActFunction` (:func:`dense_act`) is the JAX
``custom_vjp``: the kernel forward, and a backward of two plain fp32
products and a mask recomputed from the saved output (relu: ``out > 0``;
sigmoid: ``out (1 - out)``), as the JAX package leaves them to XLA.
:func:`mlp_pallas` chains the layers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..utils import build

__all__ = ["fused_dense_act", "fused_dense_act_reference", "dense_act",
           "DenseActFunction", "mlp_pallas", "ACTIVATIONS", "ROUTES"]

#: activation -> the kernel's code
ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}


def _activation_code(activation: str) -> int:
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not supported; one of "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[activation]


def _activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return torch.relu(h)
    if activation == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-h))
    return h


def fused_dense_act_reference(x: torch.Tensor, w: torch.Tensor,
                              b: Optional[torch.Tensor] = None,
                              activation: str = "relu") -> torch.Tensor:
    """Plain PyTorch: act(x @ w + b) in fp32, cast to x's dtype."""
    _activation_code(activation)
    h = x.float() @ w.float()
    if b is not None:
        h = h + b.float()
    return _activate(h, activation).to(x.dtype)


def _check_cuda_inputs(x, w, b):
    """What the kernel takes, checked before a launch; the dtype code."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_dense_act takes x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        raise TypeError(f"fused_dense_act kernel takes x, w and b of one "
                        f"dtype, got {x.dtype}, {w.dtype}, "
                        f"{None if b is None else b.dtype}")
    code = build.dtype_code(x.dtype, "the dense-act kernel")
    (m, k), n = x.shape, w.shape[1]
    if min(m, n, k) < 1 or -(-m // 64) > 65535:
        raise ValueError(f"fused_dense_act kernel takes 1 <= M <= 4194240 "
                         f"and N, K >= 1, got M, N, K = {m}, {n}, {k}")
    if b is not None and b.shape != (n,):
        raise ValueError(f"b must be ({n},), got {tuple(b.shape)}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_dense_act kernel needs a contiguous "
                             f"{name}")
    return code


#: the CUDA kernel each route launches
ROUTES = {"sm90": "dense_act_sm90_kernel", "mma": "dense_act_mma_kernel",
          "f32": "dense_act_f32_kernel"}


def _route(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel :func:`fused_dense_act` launches for inputs that passed
    :func:`_check_cuda_inputs`: ``"f32"`` for fp32; ``"sm90"`` for fp16 /
    bf16 whose operands TMA can take (row strides of K and N elements
    multiples of 16 bytes, x and w 16-byte aligned; the output is a fresh
    allocation, aligned; the bias is read element by element); ``"mma"``
    for the other fp16 / bf16 inputs.  Reads shapes, dtypes and addresses
    only."""
    if x.dtype == torch.float32:
        return "f32"
    k, n = w.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "sm90" if k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def fused_dense_act(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None,
                    activation: str = "relu") -> torch.Tensor:
    """act(x @ w + b) for x (M, K), w (K, N), b (N,) or None; the product
    accumulates in fp32, the output is in x's dtype.  x, w and b are fp32,
    bf16 or fp16; any M, N, K >= 1.  Where their dtypes differ (amp O1 / O4
    cast x alone, as the JAX package's ``half_function`` does) the kernel
    takes them widened to fp32, which is the plain version's arithmetic.

    A CUDA tensor launches the kernel :func:`_route` names (or raises); a
    CPU tensor takes the plain version."""
    if not x.is_cuda:
        return fused_dense_act_reference(x, w, b, activation)
    if w.dtype != x.dtype or (b is not None and b.dtype != x.dtype):
        return fused_dense_act(
            x.float(), w.float(), None if b is None else b.float(),
            activation).to(x.dtype)
    act = _activation_code(activation)
    code = _check_cuda_inputs(x, w, b)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.library()
    entry = lib.apex_dense_act_sm90 if _route(x, w) == "sm90" \
        else lib.apex_dense_act
    err = entry(
        x.data_ptr(), w.data_ptr(), b.data_ptr() if b is not None else None,
        out.data_ptr(), m, n, k, act, code, build.stream_of(x))
    build.check(err, "dense_act")
    build.launched("dense_act", x, w, b, out)
    return out


class DenseActFunction(torch.autograd.Function):
    """act(x @ w + b): :func:`fused_dense_act` forward; the backward of the
    JAX ``_dense_bwd`` (``apex_tpu/ops/fused_mlp.py:122-133``)."""

    @staticmethod
    def forward(ctx, x, w, b, activation):
        out = fused_dense_act(x, w, b, activation)
        ctx.save_for_backward(x, w, out)
        ctx.activation = activation
        ctx.b_dtype = b.dtype if b is not None else None
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, out = ctx.saved_tensors
        g32 = g.float()
        if ctx.activation == "relu":
            g32 = g32 * (out > 0)
        elif ctx.activation == "sigmoid":
            o32 = out.float()
            g32 = g32 * o32 * (1.0 - o32)
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = (g32 @ w.float().T).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = (x.float().T @ g32).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            gb = g32.sum(dim=0).to(ctx.b_dtype)
        return gx, gw, gb, None


def dense_act(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None,
              activation: str = "relu") -> torch.Tensor:
    """Differentiable fused GEMM + bias + activation (kernel forward,
    plain fp32 backward products)."""
    return DenseActFunction.apply(x, w, b, activation)


def mlp_pallas(x: torch.Tensor, weights: Sequence[torch.Tensor],
               biases: Sequence[Optional[torch.Tensor]],
               activation: str = "relu") -> torch.Tensor:
    """The whole MLP forward, one :func:`dense_act` a layer; the activation
    follows every layer, the last included.  Differentiable."""
    h = x
    for w, b in zip(weights, biases):
        h = dense_act(h, w, b, activation)
    return h
