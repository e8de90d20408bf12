"""The multi-tensor engine's kernels over flat buffers.

Counterpart of ``apex_tpu/multi_tensor_apply/kernels.py``.  Ported so far:
:func:`multi_tensor_l2norm`, the global-grad-norm reduction FusedLAMB's clip
rides on (kernel ``apex_tpu_torch/csrc/multi_tensor.cu``; two passes with a
fixed grid, so the result is the same bits on every call).  It launches the
kernel for a CUDA tensor and takes :func:`multi_tensor_l2norm_reference`
only for a CPU tensor.  ``multi_tensor_scale``, ``multi_tensor_axpby``,
``fused_adam_flat`` and ``fused_lamb_stage1_flat`` are off the training
path and not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from ..utils import build

__all__ = ["multi_tensor_l2norm", "multi_tensor_l2norm_reference",
           "L2NORM_MAX_BLOCKS"]

#: first-pass grid of the l2norm kernel: at most this many blocks of 256
#: threads (one fp32 partial each)
L2NORM_MAX_BLOCKS = 1024
_THREADS = 256
_VEC_BYTES = 16


def multi_tensor_l2norm_reference(flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: sqrt(sum x^2) in fp32, 0-d."""
    x = flat.float()
    return torch.sqrt((x * x).sum())


def multi_tensor_l2norm(flat: torch.Tensor) -> torch.Tensor:
    """sqrt(sum x^2) over a 1-D buffer (fp32 or bf16), accumulated in fp32;
    a 0-d fp32 tensor on the buffer's device."""
    if not flat.is_cuda:
        return multi_tensor_l2norm_reference(flat)
    if flat.dim() != 1:
        raise ValueError(f"l2norm takes a 1-D flat buffer, got shape "
                         f"{tuple(flat.shape)}")
    n = flat.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=flat.device)
    if not flat.is_contiguous() or flat.data_ptr() % _VEC_BYTES:
        raise ValueError("l2norm kernel needs a contiguous, 16-byte aligned "
                         "buffer")
    code = build.dtype_code(flat.dtype)
    per_block = _THREADS * (_VEC_BYTES // flat.element_size())
    n_blocks = max(1, min(L2NORM_MAX_BLOCKS, -(-n // per_block)))
    partials = torch.empty(n_blocks, dtype=torch.float32, device=flat.device)
    out = torch.empty((), dtype=torch.float32, device=flat.device)
    err = build.library().apex_l2norm(
        flat.data_ptr(), n, partials.data_ptr(), n_blocks, out.data_ptr(),
        code, build.stream_of(flat))
    build.check(err, "l2norm")
    build.LAUNCHES["l2norm"] += 1
    return out
