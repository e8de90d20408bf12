"""The multi-tensor engine's kernels over flat buffers.

Counterpart of ``apex_tpu/multi_tensor_apply/kernels.py``.  Ported so far,
each a kernel of ``apex_tpu_torch/csrc/multi_tensor.cu`` with its plain
PyTorch version beside it:

- :func:`multi_tensor_l2norm`, the global-grad-norm reduction FusedLAMB's
  clip rides on (two passes with a fixed grid, so the result is the same
  bits on every call);
- :func:`fused_adam_flat` and :func:`fused_lamb_stage1_flat`, the ZeRO
  optimizers' elementwise updates on their flat fp32 shards
  (:mod:`apex_tpu_torch.contrib.optimizers`).  Their hyperparameters are
  a (1, 8) / (1, 9) fp32 tensor in the JAX package's layout, read by the
  kernel on the card, so a clip or bias correction computed there never
  passes through the host;
- :func:`multi_tensor_scale` (out = x * scale) and
  :func:`multi_tensor_axpby` (out = a * x + b * y), fp32 / bf16 / fp16 in
  and out, each with the overflow flag of the JAX package: a 0-d int32,
  1 when any element of the output (after the cast to ``out_dtype``) is
  not finite.  The contrib ``FP16_Optimizer`` unscales its flat gradients
  through the first; the ``multi_tensor_applier`` facade reaches both.
  A scalar (scale, a, b) is a Python number or a one-element tensor on
  the buffers' device, read by the kernel: ``1 / loss_scale`` stays on
  the card.

Each launches its kernel for CUDA tensors and takes its ``*_reference``
only for CPU tensors.
"""
from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch

from ..utils import build

__all__ = ["multi_tensor_l2norm", "multi_tensor_l2norm_reference",
           "fused_adam_flat", "fused_adam_flat_reference",
           "fused_lamb_stage1_flat", "fused_lamb_stage1_flat_reference",
           "multi_tensor_scale", "multi_tensor_scale_reference",
           "multi_tensor_axpby", "multi_tensor_axpby_reference",
           "L2NORM_MAX_BLOCKS"]

#: first-pass grid of the l2norm kernel: at most this many blocks of 256
#: threads (one fp32 partial each)
L2NORM_MAX_BLOCKS = 1024
#: grid of the elementwise update kernels: at most this many blocks of 256
#: threads, grid-stride over 4-element vectors
UPDATE_MAX_BLOCKS = 4096
_THREADS = 256
_VEC_BYTES = 16
_COPY_NONE = -1


def multi_tensor_l2norm_reference(flat: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch: sqrt(sum x^2) in fp32, 0-d."""
    x = flat.float()
    return torch.sqrt((x * x).sum())


def _check_l2norm_input(flat: torch.Tensor) -> int:
    """What the kernel takes, checked before a launch; its dtype code."""
    if flat.dim() != 1:
        raise ValueError(f"l2norm takes a 1-D flat buffer, got shape "
                         f"{tuple(flat.shape)}")
    code = build.dtype_code(flat.dtype, "the l2norm kernel")
    if not flat.is_contiguous() or flat.data_ptr() % _VEC_BYTES:
        raise ValueError("l2norm kernel needs a contiguous, 16-byte aligned "
                         "buffer")
    return code


def multi_tensor_l2norm(flat: torch.Tensor) -> torch.Tensor:
    """sqrt(sum x^2) over a 1-D buffer (fp32, bf16 or fp16), accumulated in
    fp32; a 0-d fp32 tensor on the buffer's device."""
    if not flat.is_cuda:
        return multi_tensor_l2norm_reference(flat)
    code = _check_l2norm_input(flat)
    n = flat.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float32, device=flat.device)
    per_block = _THREADS * (_VEC_BYTES // flat.element_size())
    n_blocks = max(1, min(L2NORM_MAX_BLOCKS, -(-n // per_block)))
    partials = torch.empty(n_blocks, dtype=torch.float32, device=flat.device)
    out = torch.empty((), dtype=torch.float32, device=flat.device)
    err = build.library().apex_l2norm(
        flat.data_ptr(), n, partials.data_ptr(), n_blocks, out.data_ptr(),
        code, build.stream_of(flat))
    build.check(err, "l2norm")
    build.launched("l2norm", flat, partials, out)
    return out


# ---------------------------------------------------------------------------
# Adam / AdamW and LAMB stage 1 on flat fp32 buffers
# ---------------------------------------------------------------------------

def _moments(g, p, m, v, b1, b2, eps, wd, rc1, rc2, c1, adam_w_mode):
    """m, v and the step direction u, in the TPU kernels' order; ``g`` is
    already scaled."""
    if not adam_w_mode:
        g = g + wd * p                 # classic L2 (ADAM_MODE_0)
    m = b1 * m + c1 * g
    v = b2 * v + (1.0 - b2) * g * g
    u = (m * rc1) / (torch.sqrt(v * rc2) + eps)
    if adam_w_mode:
        u = u + wd * p                 # decoupled decay (ADAM_MODE_1)
    return u, m, v


def fused_adam_flat_reference(flat_g, flat_p, flat_m, flat_v, scalars, *,
                              adam_w_mode=True, model_dtype=None
                              ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`fused_adam_flat`: the JAX kernel's
    body (``kernels.py:207-226``) over whole buffers."""
    s = scalars.reshape(-1).float()
    lr, b1, b2, eps, wd, rc1, rc2, scale = (s[i] for i in range(8))
    g = flat_g.float() * scale
    p = flat_p.float()
    u, m, v = _moments(g, p, flat_m.float(), flat_v.float(), b1, b2, eps, wd,
                       rc1, rc2, 1.0 - b1, adam_w_mode)
    p_new = p - lr * u
    outs = [p_new, m, v]
    if model_dtype is not None:
        outs.append(p_new.to(model_dtype))
    return outs


def fused_lamb_stage1_flat_reference(flat_g, flat_p, flat_m, flat_v,
                                     scalars, *, adam_w_mode=True
                                     ) -> List[torch.Tensor]:
    """Plain PyTorch version of :func:`fused_lamb_stage1_flat`: the JAX
    kernel's body (``kernels.py:245-261``) over whole buffers."""
    s = scalars.reshape(-1).float()
    b1, b2, eps, wd, rc1, rc2, clip, inv_scale, beta3 = (s[i]
                                                         for i in range(9))
    g = flat_g.float() * inv_scale * clip
    u, m, v = _moments(g, flat_p.float(), flat_m.float(), flat_v.float(), b1,
                       b2, eps, wd, rc1, rc2, beta3, adam_w_mode)
    return [u, m, v]


def _check_update_inputs(name, bufs, scalars, n_scalars):
    n = bufs[0].numel()
    for t in bufs:
        if t.device != bufs[0].device or t.dtype != torch.float32 \
                or t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} takes 1-D fp32 g, p, m, v of one "
                             f"length on one device, got "
                             f"{[(tuple(b.shape), b.dtype) for b in bufs]}")
        if not t.is_contiguous() or t.data_ptr() % _VEC_BYTES:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             f"aligned buffers")
    if scalars.device != bufs[0].device or scalars.dtype != torch.float32 \
            or scalars.numel() != n_scalars or not scalars.is_contiguous():
        raise ValueError(f"{name} takes {n_scalars} contiguous fp32 scalars "
                         f"on {bufs[0].device}, got {tuple(scalars.shape)} "
                         f"{scalars.dtype} on {scalars.device}")
    return n


def _copy_code(model_dtype: Optional[torch.dtype]) -> int:
    """The code of Adam's model copy: none, fp32, bf16 or fp16."""
    if model_dtype is None:
        return _COPY_NONE
    return build.dtype_code(model_dtype, "the Adam kernel's model copy")


def _update_blocks(n: int) -> int:
    return max(1, min(UPDATE_MAX_BLOCKS, -(-n // (4 * _THREADS))))


def fused_adam_flat(flat_g, flat_p, flat_m, flat_v, scalars, *,
                    adam_w_mode=True, model_dtype=None
                    ) -> List[torch.Tensor]:
    """Adam / AdamW over flat fp32 g, p, m, v.  ``scalars`` (1, 8) fp32:
    [lr, beta1, beta2, eps, wd, rc1, rc2, scale] with rc1 = 1/(1-beta1^t),
    rc2 = 1/(1-beta2^t) and ``scale`` the gradient's multiplier (unscale
    times clip).  Returns new [p, m, v] (+ p in ``model_dtype``, fp32, bf16
    or fp16, when given)."""
    if not flat_g.is_cuda:
        return fused_adam_flat_reference(flat_g, flat_p, flat_m, flat_v,
                                         scalars, adam_w_mode=adam_w_mode,
                                         model_dtype=model_dtype)
    n = _check_update_inputs("fused_adam_flat",
                             (flat_g, flat_p, flat_m, flat_v), scalars, 8)
    p_out, m_out, v_out = (torch.empty_like(flat_p) for _ in range(3))
    copy: Optional[torch.Tensor] = None
    code = _copy_code(model_dtype)
    if model_dtype is not None:
        copy = torch.empty(n, dtype=model_dtype, device=flat_p.device)
    if n == 0:
        return [p_out, m_out, v_out] + ([copy] if copy is not None else [])
    err = build.library().apex_fused_adam(
        flat_g.data_ptr(), flat_p.data_ptr(), flat_m.data_ptr(),
        flat_v.data_ptr(), scalars.data_ptr(), p_out.data_ptr(),
        m_out.data_ptr(), v_out.data_ptr(),
        copy.data_ptr() if copy is not None else None, n, _update_blocks(n),
        int(bool(adam_w_mode)), code, build.stream_of(flat_g))
    build.check(err, "adam")
    build.launched("adam", flat_g, flat_p, flat_m, flat_v, scalars, p_out,
                   m_out, v_out, copy)
    return [p_out, m_out, v_out] + ([copy] if copy is not None else [])


def fused_lamb_stage1_flat(flat_g, flat_p, flat_m, flat_v, scalars, *,
                           adam_w_mode=True) -> List[torch.Tensor]:
    """LAMB stage 1 over flat fp32 g, p, m, v.  ``scalars`` (1, 9) fp32:
    [beta1, beta2, eps, wd, rc1, rc2, clip, inv_scale, beta3] with clip =
    1/max(1, norm/max_grad_norm) and beta3 = 1-beta1 under grad averaging,
    else 1.  Returns [u, m, v]: the unscaled step direction and the new
    moments (stage 2, the trust ratios, is the caller's)."""
    if not flat_g.is_cuda:
        return fused_lamb_stage1_flat_reference(
            flat_g, flat_p, flat_m, flat_v, scalars, adam_w_mode=adam_w_mode)
    n = _check_update_inputs("fused_lamb_stage1_flat",
                             (flat_g, flat_p, flat_m, flat_v), scalars, 9)
    u, m_out, v_out = (torch.empty_like(flat_p) for _ in range(3))
    if n == 0:
        return [u, m_out, v_out]
    err = build.library().apex_lamb_stage1(
        flat_g.data_ptr(), flat_p.data_ptr(), flat_m.data_ptr(),
        flat_v.data_ptr(), scalars.data_ptr(), u.data_ptr(),
        m_out.data_ptr(), v_out.data_ptr(), n, _update_blocks(n),
        int(bool(adam_w_mode)), build.stream_of(flat_g))
    build.check(err, "lamb_stage1")
    build.launched("lamb_stage1", flat_g, flat_p, flat_m, flat_v, scalars,
                   u, m_out, v_out)
    return [u, m_out, v_out]


# ---------------------------------------------------------------------------
# multi_tensor_scale and multi_tensor_axpby, with the overflow flag
# ---------------------------------------------------------------------------

Scalar = Union[float, torch.Tensor]


def _f32_scalar(s: Scalar, device) -> torch.Tensor:
    """A scale as a 0-d fp32 tensor, as the JAX kernels take it."""
    if isinstance(s, torch.Tensor):
        return s.reshape(()).to(device, torch.float32)
    # a fill on the device, not a host copy (capturable in a CUDA graph)
    return torch.full((), float(s), dtype=torch.float32, device=device)


def _overflow_flag(out: torch.Tensor) -> torch.Tensor:
    """0-d int32: 1 when any element of ``out`` is not finite (the JAX
    package's ``_overflow_flag``)."""
    return (~torch.isfinite(out).all()).to(torch.int32)


def multi_tensor_scale_reference(flat_in, scale, out_dtype=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`multi_tensor_scale`."""
    out = (flat_in.float() * _f32_scalar(scale, flat_in.device)).to(
        out_dtype or flat_in.dtype)
    return out, _overflow_flag(out)


def multi_tensor_axpby_reference(flat_x, flat_y, a, b, out_dtype=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`multi_tensor_axpby`: x * a + y * b
    in fp32, in the JAX kernel's order, then the cast."""
    dev = flat_x.device
    out = (flat_x.float() * _f32_scalar(a, dev)
           + flat_y.float() * _f32_scalar(b, dev)).to(
               out_dtype or flat_x.dtype)
    return out, _overflow_flag(out)


def _scalar_arg(s: Scalar, device) -> Tuple[Optional[int], float,
                                            Optional[torch.Tensor]]:
    """(device pointer or None, value, the tensor to keep alive) of a
    scale: a one-element tensor is read by the kernel, a number is passed
    by value."""
    if isinstance(s, torch.Tensor):
        if s.numel() != 1 or s.device != device:
            raise ValueError(f"a tensor scale must have one element on "
                             f"{device}, got {tuple(s.shape)} on {s.device}")
        t = s.reshape(()).to(torch.float32).contiguous()
        return t.data_ptr(), 0.0, t
    return None, float(s), None


def _scale_axpby(name, key, xs, scalars, out_dtype):
    """Check, allocate the output and the zeroed flag, launch, count."""
    x = xs[0]
    out_dtype = out_dtype or x.dtype
    n = x.numel()
    in_code = build.dtype_code(x.dtype, f"{name}'s input")
    out_code = build.dtype_code(out_dtype, f"{name}'s output")
    for t in xs:
        if t.dtype != x.dtype:
            raise TypeError(f"{name} takes buffers of one dtype, got "
                            f"{[b.dtype for b in xs]}")
        if t.dim() != 1 or t.numel() != n or t.device != x.device:
            raise ValueError(f"{name} takes 1-D buffers of one length on one "
                             f"device, got {[tuple(b.shape) for b in xs]}")
        if not t.is_contiguous() or t.data_ptr() % _VEC_BYTES:
            raise ValueError(f"{name} kernel needs contiguous, 16-byte "
                             f"aligned buffers")
    (a_ptr, a, a_keep), (b_ptr, b, b_keep) = [
        _scalar_arg(s, x.device) for s in scalars] + [(None, 0.0, None)] * (
            2 - len(scalars))
    out = torch.empty(n, dtype=out_dtype, device=x.device)
    flag = torch.zeros((), dtype=torch.int32, device=x.device)
    if n == 0:
        return out, flag
    err = build.library().apex_mt_scale_axpby(
        x.data_ptr(), xs[1].data_ptr() if len(xs) > 1 else None, a_ptr, a,
        b_ptr, b, out.data_ptr(), flag.data_ptr(), n, _update_blocks(n),
        in_code, out_code, build.stream_of(x))
    build.check(err, name)
    build.launched(key, *xs, a_keep, b_keep, out, flag)
    return out, flag


def multi_tensor_scale(flat_in: torch.Tensor, scale: Scalar, out_dtype=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out = flat_in * scale in fp32, cast to ``out_dtype`` (default the
    input's); returns (out, flag), ``flag`` a 0-d int32 on the device: 1
    when any element of ``out`` is not finite.  No host read."""
    if not flat_in.is_cuda:
        return multi_tensor_scale_reference(flat_in, scale, out_dtype)
    return _scale_axpby("multi_tensor_scale", "mt_scale", (flat_in,),
                        (scale,), out_dtype)


def multi_tensor_axpby(flat_x: torch.Tensor, flat_y: torch.Tensor,
                       a: Scalar, b: Scalar, out_dtype=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """out = a * x + b * y in fp32, cast to ``out_dtype`` (default x's);
    returns (out, flag) as :func:`multi_tensor_scale`."""
    if not flat_x.is_cuda:
        return multi_tensor_axpby_reference(flat_x, flat_y, a, b, out_dtype)
    return _scale_axpby("multi_tensor_axpby", "mt_axpby", (flat_x, flat_y),
                        (a, b), out_dtype)
