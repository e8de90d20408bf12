"""The control's precision: float8, the step below the bfloat16 / float16
the configurations state, wherever the program keeps a value in those:
every product's operands and every activation kept between operations go
forward in e4m3 and their gradients come back in e5m2 (the usual float8
training recipe), each tensor with one scale from its largest magnitude."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in e4m3 going forward, its gradient in e5m2 coming back."""
    return _Fp8.apply(x)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return round_fp8(a) @ round_fp8(b)


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    from .resnet import conv as plain
    return plain(round_fp8(x), round_fp8(w), stride)
