"""Layer norm: the hand-written Hopper kernels and their plain versions.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (``ln_fwd_pallas``,
``ln_bwd_pallas``, ``layer_norm_pallas``).  Both kernels are in
``apex_tpu_torch/csrc/layer_norm.cu``; :func:`ln_fwd` and :func:`ln_bwd`
launch them for a CUDA tensor and take :func:`ln_fwd_reference` /
:func:`ln_bwd_reference` only for a CPU tensor.  The forward returns the
TPU kernel's residual contract ``(out (N, H) in x's dtype, mean (N, 1) f32,
invvar (N, 1) f32)``; the backward takes it back and gives dx.
:class:`LayerNormFunction` pairs the two as a ``torch.autograd.Function``
whose dw and db are plain fp32 column sums, as in the JAX package.  The
kernels take any width and any alignment: :func:`_ln_plan` picks their
path (:data:`LN_PATHS`) from the row's width, dtype and alignment.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import build

__all__ = ["ln_fwd", "ln_fwd_reference", "ln_bwd", "ln_bwd_reference",
           "LayerNormFunction", "MAX_H", "LN_PATHS"]

#: widest row the register paths hold: 1024 16-byte vectors (4096 fp32,
#: 8192 bf16 or fp16); a wider row takes the wide path, not a refusal
MAX_H = {torch.float32: 4096, torch.bfloat16: 8192, torch.float16: 8192}
#: the kernels' paths, by their C code (``layer_norm.cu``): a row in
#: registers held by a warp or by a 256-thread block; a 512-thread block a
#: row with the row staged in shared memory, or re-read from device memory
LN_PATHS = ("warp", "block", "wide_smem", "wide_reread")
# loads a thread of the register paths holds, and their threads a row
_MAXV, _WARP, _BLOCK = 4, 32, 256
# a block's shared memory on Hopper less the kernels' static scratch
_MAX_SMEM = 232448 - 1024


def _ln_plan(h: int, dtype: torch.dtype, aligned: bool,
             backward: bool = False) -> Tuple[str, bool]:
    """(path in :data:`LN_PATHS`, 16-byte loads?) for rows of ``h``
    elements of ``dtype``.  ``aligned``: every row pointer the kernel reads
    or writes is 16-byte aligned (each tensor's data pointer is, and H is a
    multiple of the 16-byte vector); else element loads.  The wide path
    stages x (the backward: g and x) in shared memory while it fits."""
    size = torch.empty((), dtype=dtype).element_size()
    vec = aligned and h % (16 // size) == 0
    loads = h // (16 // size) if vec else h
    if loads <= _WARP * _MAXV:
        return "warp", vec
    if loads <= _BLOCK * _MAXV:
        return "block", vec
    row_bytes = -(-h * size // 16) * 16
    staged = (2 if backward else 1) * row_bytes <= _MAX_SMEM
    return ("wide_smem" if staged else "wide_reread"), vec


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def ln_fwd_reference(x2d: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch: two-pass fp32 statistics, as the TPU kernel."""
    x = x2d.float()
    mean = x.mean(dim=1, keepdim=True)
    xc = x - mean
    var = (xc * xc).mean(dim=1, keepdim=True)
    invvar = torch.rsqrt(var + eps)
    out = xc * invvar
    if weight is not None:
        out = out * weight.float() + bias.float()
    return out.to(x2d.dtype), mean, invvar


def _check_cuda_inputs(x2d, weight, bias):
    if x2d.dim() != 2:
        raise ValueError(f"ln_fwd takes x (N, H), got shape {tuple(x2d.shape)}")
    n, h = x2d.shape
    build.dtype_code(x2d.dtype, "the layer-norm x")
    if n == 0 or h == 0:
        raise ValueError(f"ln_fwd kernel needs N > 0 and H > 0, got ({n}, {h})")
    if not x2d.is_contiguous():
        raise ValueError("ln_fwd kernel needs a contiguous x")
    if (weight is None) != (bias is None):
        raise ValueError("ln_fwd takes both weight and bias, or neither")
    if weight is not None:
        _check_param(weight, "weight", x2d)
        _check_param(bias, "bias", x2d)
        if weight.dtype != bias.dtype:
            raise TypeError("weight and bias must share a dtype")


def _check_param(t, name, x2d):
    h = x2d.shape[1]
    if t.device != x2d.device:
        raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
    if t.shape != (h,) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous ({h},), got "
                         f"{tuple(t.shape)}")
    build.dtype_code(t.dtype, f"the layer-norm {name}")


def ln_fwd(x2d: torch.Tensor, weight: Optional[torch.Tensor],
           bias: Optional[torch.Tensor], eps: float
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d (N, H) -> (out (N, H), mean (N, 1) f32, invvar (N, 1) f32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if not x2d.is_cuda:
        return ln_fwd_reference(x2d, weight, bias, eps)
    _check_cuda_inputs(x2d, weight, bias)
    n, h = x2d.shape
    out = torch.empty_like(x2d)
    mean = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    invvar = torch.empty((n, 1), dtype=torch.float32, device=x2d.device)
    code = build.dtype_code(x2d.dtype, "the layer-norm x")
    w_code = (build.dtype_code(weight.dtype, "the layer-norm weight")
              if weight is not None else code)
    path, vec = _ln_plan(h, x2d.dtype, _aligned(x2d, out, weight, bias))
    err = build.library().apex_ln_fwd(
        x2d.data_ptr(),
        weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
        n, h, float(eps), code, w_code, LN_PATHS.index(path), int(vec),
        build.stream_of(x2d))
    build.check(err, "ln_fwd")
    build.launched("ln_fwd", x2d, weight, bias, out, mean, invvar)
    return out, mean, invvar


def ln_bwd_reference(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
                     invvar: torch.Tensor, weight: Optional[torch.Tensor]
                     ) -> torch.Tensor:
    """Plain PyTorch: the TPU kernel's formula in fp32, dx in x's dtype."""
    g = g2d.float()
    xhat = (x2d.float() - mean) * invvar
    gw = g * weight.float() if weight is not None else g
    m1 = gw.mean(dim=1, keepdim=True)
    m2 = (gw * xhat).mean(dim=1, keepdim=True)
    return ((gw - m1 - xhat * m2) * invvar).to(x2d.dtype)


def ln_bwd(g2d: torch.Tensor, x2d: torch.Tensor, mean: torch.Tensor,
           invvar: torch.Tensor, weight: Optional[torch.Tensor]
           ) -> torch.Tensor:
    """dx (N, H) in x's dtype from the saved residuals mean/invvar (N, 1)
    f32; ``weight`` (H,) or None.  dw and db are the caller's column sums.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if not x2d.is_cuda:
        return ln_bwd_reference(g2d, x2d, mean, invvar, weight)
    _check_cuda_inputs(x2d, None, None)
    n, h = x2d.shape
    if g2d.shape != x2d.shape or g2d.dtype != x2d.dtype \
            or g2d.device != x2d.device:
        raise ValueError(f"ln_bwd: g {tuple(g2d.shape)} {g2d.dtype} does not "
                         f"match x {tuple(x2d.shape)} {x2d.dtype}")
    if not g2d.is_contiguous():
        raise ValueError("ln_bwd kernel needs a contiguous g")
    for name, t in (("mean", mean), ("invvar", invvar)):
        if t.dtype != torch.float32 or t.numel() != n \
                or not t.is_contiguous() or t.device != x2d.device:
            raise ValueError(f"ln_bwd: {name} must be contiguous float32 "
                             f"({n}, 1) on {x2d.device}")
    if weight is not None:
        _check_param(weight, "weight", x2d)
    dx = torch.empty_like(x2d)
    code = build.dtype_code(x2d.dtype, "the layer-norm x")
    w_code = (build.dtype_code(weight.dtype, "the layer-norm weight")
              if weight is not None else code)
    path, vec = _ln_plan(h, x2d.dtype, _aligned(g2d, x2d, dx, weight),
                         backward=True)
    err = build.library().apex_ln_bwd(
        g2d.data_ptr(), x2d.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
        weight.data_ptr() if weight is not None else None, dx.data_ptr(),
        n, h, code, w_code, LN_PATHS.index(path), int(vec),
        build.stream_of(x2d))
    build.check(err, "ln_bwd")
    build.launched("ln_bwd", g2d, x2d, mean, invvar, weight, dx)
    return dx


class LayerNormFunction(torch.autograd.Function):
    """Layer norm of x2d (N, H) with an optional affine: :func:`ln_fwd`
    forward, :func:`ln_bwd` for dx, and dw / db as fp32 column sums cast to
    the parameters' dtype (``apex_tpu/ops/layer_norm.py:218-233``).
    ``plain=True`` takes :func:`ln_fwd_reference` / :func:`ln_bwd_reference`
    whatever the device: the JAX package's XLA VJP
    (``apex_tpu/normalization/fused_layer_norm.py:50-97``), no kernel."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, eps, plain=False):
        fwd = ln_fwd_reference if plain else ln_fwd
        out, mean, invvar = fwd(x2d, weight, bias, eps)
        ctx.save_for_backward(x2d, weight, mean, invvar)
        ctx.bias_dtype = bias.dtype if bias is not None else None
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, weight, mean, invvar = ctx.saved_tensors
        g = g.contiguous()
        dx = (ln_bwd_reference if ctx.plain else ln_bwd)(g, x2d, mean, invvar,
                                                        weight)
        dw = db = None
        if weight is not None and ctx.needs_input_grad[1]:
            xhat = (x2d.float() - mean) * invvar
            dw = (g.float() * xhat).sum(dim=0).to(weight.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g.float().sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db, None, None
