"""Layer-norm forward: the hand-written Hopper kernel and its plain version.

Counterpart of ``apex_tpu/ops/layer_norm.py`` (``ln_fwd_pallas``).  The
kernel is ``apex_tpu_torch/csrc/layer_norm.cu``; :func:`ln_fwd` launches it
for a CUDA tensor and takes :func:`ln_fwd_reference` only for a CPU tensor.
Both return the same residual contract as the TPU kernel:
``(out (N, H) in x's dtype, mean (N, 1) f32, invvar (N, 1) f32)``.

Only the forward is ported in this slice.  A CUDA input that requires a
gradient raises: the backward kernel comes with the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import build

__all__ = ["ln_fwd", "ln_fwd_reference", "MAX_H"]

#: widest row the kernel takes: 1024 16-byte vectors (4096 fp32, 8192 bf16)
MAX_H = {torch.float32: 4096, torch.bfloat16: 8192}


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
    if x2d.dtype not in MAX_H:
        raise TypeError(f"ln_fwd kernel takes float32/bfloat16, got {x2d.dtype}")
    if h % 8 or h > MAX_H[x2d.dtype] or n == 0:
        raise ValueError(f"ln_fwd kernel needs N > 0 and H a multiple of 8 up "
                         f"to {MAX_H[x2d.dtype]} for {x2d.dtype}, got ({n}, {h})")
    if not x2d.is_contiguous() or x2d.data_ptr() % 16:
        raise ValueError("ln_fwd kernel needs a contiguous, 16-byte aligned x")
    if (weight is None) != (bias is None):
        raise ValueError("ln_fwd takes both weight and bias, or neither")
    tensors = [x2d] + ([weight, bias] if weight is not None else [])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "ln_fwd on CUDA is forward-only: the layer-norm backward kernel "
            "comes with the training slice (see ROADMAP.md)")
    if weight is not None:
        for name, t in (("weight", weight), ("bias", bias)):
            if t.device != x2d.device:
                raise ValueError(f"{name} is on {t.device}, x on {x2d.device}")
            if t.shape != (h,) or not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous ({h},), got "
                                 f"{tuple(t.shape)}")
        if weight.dtype != bias.dtype:
            raise TypeError("weight and bias must share a dtype")
        build.dtype_code(weight.dtype)


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
    code = build.dtype_code(x2d.dtype)
    w_code = build.dtype_code(weight.dtype) if weight is not None else code
    err = build.library().apex_ln_fwd(
        x2d.data_ptr(),
        weight.data_ptr() if weight is not None else None,
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), mean.data_ptr(), invvar.data_ptr(),
        n, h, float(eps), code, w_code, build.stream_of(x2d))
    build.check(err, "ln_fwd")
    build.LAUNCHES["ln_fwd"] += 1
    return out, mean, invvar
