"""Fused label-smoothing softmax cross-entropy: the hand-written Hopper
forward kernel and its plain version.

Counterpart of ``apex_tpu/contrib/xentropy/softmax_xentropy.py``:

    loss_i = (1 - smoothing) * (lse_i - x_i[label_i])
             + smoothing * (lse_i - mean_j x_i[j])        (0 where padding)

The forward saves only the log-sum-exp; the backward needs no re-reduction:

    dx_i = g_i * (softmax(x_i) - (1 - s) * onehot(label_i) - s / V)

The forward kernel is ``apex_tpu_torch/csrc/xentropy.cu``: :func:`_xent_fwd`
launches it for a CUDA tensor and takes :func:`_xent_fwd_reference` only for
a CPU tensor.  :func:`_xent_plan` picks its instance from the row's width
and dtype: 8, 16 or 32 lanes a row for rows of up to 2 KB, a
shared-memory ring fed by bulk copies past that.  The backward is plain PyTorch, as the JAX package's is plain
XLA.  ``impl``: ``"pallas"`` (the JAX package's name for its kernel route,
kept so the config field keeps its meaning) takes :func:`_xent_fwd`,
``"xla"`` the plain forward, and ``"auto"`` resolves in the JAX package's
order (:func:`_resolve_impl`): ``APEX_TPU_XENT_IMPL`` > the tuning
profile's ``xent_auto_impl`` (on the card only) > the kernel for a CUDA
tensor, the plain version for a CPU one.
"""
from __future__ import annotations

import os
from typing import Tuple

import torch

from ...utils import build, tuning

__all__ = ["softmax_xentropy_loss", "SoftmaxCrossEntropyLoss", "_xent_fwd",
           "_xent_fwd_reference", "_xent_plan", "XENT_IMPLS", "XENT_PATHS"]

XENT_IMPLS = ("auto", "pallas", "xla")
#: the kernel's instances, by their C code (``xentropy.cu``): 8, 16 or 32
#: lanes a row holding 1, 2 or 4 16-byte vectors each; the persistent
#: blocks streaming rows through a shared-memory ring
XENT_PATHS = ("lanes8x1", "lanes8x2", "lanes8x4", "lanes16x4", "lanes32x4",
              "wide")


def _xent_plan(v: int, dtype: torch.dtype) -> str:
    """The kernel instance (one of :data:`XENT_PATHS`) for rows of ``v``
    logits of ``dtype``, by the 16-byte vectors a row spans; the number of
    rows does not change it (every instance walks rows with persistent
    warps or blocks)."""
    loads = -(-v * torch.empty((), dtype=dtype).element_size() // 16)
    for path, most in (("lanes8x1", 8), ("lanes8x2", 16), ("lanes8x4", 32),
                       ("lanes16x4", 64), ("lanes32x4", 128)):
        if loads <= most:
            return path
    return "wide"


def _xent_fwd_reference(logits: torch.Tensor, labels: torch.Tensor,
                        smoothing: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch: (loss (N,) f32, lse (N,) f32).  A label outside
    [0, V) (a padding row) gets a gold logit of 0, as in the kernels."""
    x = logits.float()
    v = x.shape[-1]
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1))
    valid = (labels >= 0) & (labels < v)
    gold = torch.gather(x, 1, labels.clamp(0, v - 1).long()[:, None])[:, 0]
    gold = torch.where(valid, gold, torch.zeros_like(gold))
    smooth = lse - x.mean(dim=-1)
    return (1.0 - smoothing) * (lse - gold) + smoothing * smooth, lse


def _xent_fwd(logits: torch.Tensor, labels: torch.Tensor, smoothing: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (N, V), labels (N,) int -> (loss (N,) f32, lse (N,) f32).

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version."""
    if not logits.is_cuda:
        return _xent_fwd_reference(logits, labels, smoothing)
    labels, code = _check_cuda_inputs(logits, labels)
    n, v = logits.shape
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty(n, dtype=torch.float32, device=logits.device)
    err = build.library().apex_xent_fwd(
        logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), lse.data_ptr(),
        n, v, float(smoothing), code,
        XENT_PATHS.index(_xent_plan(v, logits.dtype)),
        build.stream_of(logits))
    build.check(err, "xent_fwd")
    build.launched("xent_fwd", logits, labels, loss, lse)
    return loss, lse


def _check_cuda_inputs(logits: torch.Tensor, labels: torch.Tensor):
    """What the kernel takes, checked before a launch: (labels as
    contiguous int64, the logits' dtype code)."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"xent kernel takes logits (N, V) and labels (N,), "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    n, v = logits.shape
    if n == 0:
        raise ValueError("xent kernel needs N > 0")
    if not logits.is_contiguous():
        raise ValueError("xent kernel needs contiguous logits")
    if labels.device != logits.device:
        raise ValueError(f"labels are on {labels.device}, logits on "
                         f"{logits.device}")
    if labels.dtype == torch.int32:
        labels = labels.long()
    if labels.dtype != torch.int64:
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    code = build.dtype_code(logits.dtype, "the cross-entropy kernel")
    return labels.contiguous(), code


def _resolve_impl(impl: str, device) -> str:
    """``impl`` as a route, "pallas" (the kernel) or "xla" (the plain
    forward).  "auto": ``APEX_TPU_XENT_IMPL`` > ``xent_auto_impl`` (on the
    card only) > "pallas" on a CUDA ``device``, "xla" on the CPU.  As in
    the JAX package, a resolved value other than "pallas" takes the plain
    forward."""
    if impl not in XENT_IMPLS:
        raise ValueError(f"impl must be one of {XENT_IMPLS}, got {impl!r}")
    if impl == "auto":
        impl = (os.environ.get("APEX_TPU_XENT_IMPL", "")
                or tuning.get_on_gpu("xent_auto_impl")
                or ("pallas" if torch.device(device).type == "cuda"
                    else "xla"))
    return "pallas" if impl == "pallas" else "xla"


def _fwd(logits, labels, smoothing, impl):
    if _resolve_impl(impl, logits.device) == "xla":
        return _xent_fwd_reference(logits, labels, smoothing)
    return _xent_fwd(logits, labels, smoothing)


def _check_labels(labels, v, padding_idx):
    """Labels must lie in [0, V) or equal ``padding_idx``.  Checked for CPU
    tensors only: on the card the check would cost a host sync, and the
    range is the caller's contract, as in the JAX package."""
    if labels.is_cuda:
        return
    bad = ((labels < 0) | (labels >= v)) & (labels != padding_idx)
    if bool(bad.any()):
        raise ValueError(f"labels outside [0, {v}) that are not "
                         f"padding_idx={padding_idx}: "
                         f"{labels[bad][:8].tolist()}")


class _SoftmaxXentropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, smoothing, padding_idx, half_to_float,
                impl):
        loss, lse = _fwd(logits, labels, smoothing, impl)
        pad = labels == padding_idx
        loss = torch.where(pad, torch.zeros_like(loss), loss)
        ctx.save_for_backward(logits, labels, lse)
        ctx.args = (smoothing, padding_idx)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        smoothing, padding_idx = ctx.args
        v = logits.shape[-1]
        g = torch.where(labels == padding_idx, torch.zeros_like(g), g.float())
        # softmax - s/V everywhere, then the gold column alone gets
        # softmax - (1 - s) - s/V: no (N, V) one-hot or target is built
        grad = (logits.float() - lse[:, None]).exp_()
        col = labels.clamp(0, v - 1).long()[:, None]
        valid = ((labels >= 0) & (labels < v))[:, None]
        gold = grad.gather(1, col)
        grad.sub_(smoothing / v)
        gold = torch.where(valid, gold - ((1.0 - smoothing) + smoothing / v),
                           gold - smoothing / v)
        grad.scatter_(1, col, gold).mul_(g[:, None])
        # autograd hands a gradient back in the input's dtype, so
        # half_to_float (fp32 gradients in the JAX package) has no effect
        return grad.to(logits.dtype), None, None, None, None, None


def softmax_xentropy_loss(logits, labels, smoothing=0.0, padding_idx=0,
                          half_to_float=False, impl="auto") -> torch.Tensor:
    """Per-row label-smoothing cross entropy; rows whose label equals
    ``padding_idx`` contribute 0.  logits (N, V) float; labels (N,) int.
    Returns (N,) float32 losses; differentiable in ``logits``."""
    _check_labels(labels, logits.shape[-1], padding_idx)
    return _SoftmaxXentropy.apply(logits, labels, float(smoothing),
                                  padding_idx, half_to_float, impl)


class SoftmaxCrossEntropyLoss:
    """API mirror of the reference autograd Function:
    ``SoftmaxCrossEntropyLoss.apply(...)``."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False, impl="auto"):
        return softmax_xentropy_loss(logits, labels, smoothing, padding_idx,
                                     half_to_float, impl)
