"""SyncBatchNorm: batch normalization whose statistics are summed over a
process group.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py``.  Each rank sums x
and x^2 in fp32 over every axis but the channel's; one all-reduce over the
group sums (Σx, Σx², n), so unequal per-rank batches merge by count as the
reference's Welford merge does.  The gradient of that all-reduce is an
all-reduce of the incoming gradient (:class:`_AllReduceSum`), the pattern
the JAX package gets from autodiff through ``psum``: combined with a data-
parallel gradient average it gives the gradient of the global-batch loss.

``axis_name`` is a ``torch.distributed`` process group in place of the JAX
package's mesh axis.  ``None`` means the default group when one is
initialised; with no group, or with ``()`` (the JAX package's empty axis
tuple), the op has single-device semantics, so the same model code runs
on one card unchanged.  The running statistics are returned,
never updated in place.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import check_group_device, resolve_group
from ..utils.device import resolve_device

__all__ = ["batch_norm_stats", "sync_batch_norm", "SyncBatchNorm"]


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` whose backward sums the gradient over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def _compute_dtype(x) -> torch.dtype:
    """fp32 for fp32 and narrower inputs, as the JAX package computes;
    float64 stays float64 (the JAX package, without 64-bit mode, has no
    float64 input)."""
    return torch.promote_types(x.dtype, torch.float32)


def batch_norm_stats(x, reduce_axes, axis_name):
    """Count-weighted global (mean, var, count) over ``reduce_axes`` of the
    local ``x`` and over the group: the ``welford_mean_var`` +
    ``welford_parallel`` pair.  All three are fp32 (float64 for a float64
    ``x``; the count a 0-d tensor); the variance is the biased one,
    clamped at 0."""
    group = resolve_group(axis_name)
    x32 = x.to(_compute_dtype(x))
    n_local = 1
    for a in reduce_axes:
        n_local *= x.shape[a]
    s1 = x32.sum(dim=reduce_axes)
    s2 = (x32 * x32).sum(dim=reduce_axes)
    count = torch.full((1,), float(n_local), dtype=x32.dtype,
                       device=x.device)
    if group is not None:
        check_group_device(x, group)
        c = s1.shape[0]
        buf = _AllReduceSum.apply(torch.cat([s1, s2, count]), group)
        s1, s2, count = buf[:c], buf[c:2 * c], buf[2 * c:]
    n = count.reshape(())
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=0.0)
    return mean, var, n.detach()


def sync_batch_norm(x, weight, bias, running_mean=None, running_var=None, *,
                    axis_name=None, training: bool = True,
                    momentum: float = 0.1, eps: float = 1e-5,
                    channel_last: bool = True, fuse_relu: bool = False,
                    z=None):
    """Functional SyncBatchNorm.

    x: ``(N, ..., C)`` when ``channel_last`` else ``(N, C, ...)``.  ``z`` is
    an optional residual added before the activation (the groupbn
    ``batch_norm_add_relu`` fusion).  The normalisation runs in fp32 (in
    float64 for a float64 ``x``) and the output takes x's dtype.

    Returns ``(out, new_running_mean, new_running_var)`` in training mode
    (the running variance unbiased over the global count) and ``(out,
    running_mean, running_var)`` in eval mode; without running statistics
    eval mode uses the batch's, as ``torch.nn.BatchNorm`` does.
    """
    c_axis = x.dim() - 1 if channel_last else 1
    reduce_axes = tuple(a for a in range(x.dim()) if a != c_axis)

    if training:
        mean, var, n = batch_norm_stats(x, reduce_axes, axis_name)
        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                new_rm = (1 - momentum) * running_mean + momentum * mean
                new_rv = (1 - momentum) * running_var + momentum * unbiased
        else:
            new_rm = new_rv = None
    else:
        if running_mean is None:
            mean, var, _ = batch_norm_stats(x, reduce_axes, axis_name)
        else:
            mean, var = running_mean, running_var
        new_rm, new_rv = running_mean, running_var

    ct = _compute_dtype(x)
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    inv = torch.rsqrt(var.to(ct) + eps).reshape(shape)
    out = (x.to(ct) - mean.reshape(shape)) * inv
    if weight is not None:
        out = out * weight.to(ct).reshape(shape)
    if bias is not None:
        out = out + bias.to(ct).reshape(shape)
    if z is not None:
        out = out + z.to(ct)
    if fuse_relu:
        out = torch.relu(out)
    return out.to(x.dtype), new_rm, new_rv


class SyncBatchNorm:
    """Module mirror of ``apex.parallel.SyncBatchNorm``: the constructor
    surface (num_features, eps, momentum, affine, track_running_stats,
    process_group, channel_last, fuse_relu) with ``init`` / ``apply`` over
    explicit parameter and state dicts, as the JAX package's module."""

    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None,
                 channel_last=True, fuse_relu=False):
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.axis_name = process_group
        self.channel_last = channel_last
        self.fuse_relu = fuse_relu

    def init(self, device=None):
        """(params, state): weight 1, bias 0, running mean 0 and var 1,
        fp32 on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        c = self.num_features
        params = {}
        if self.affine:
            params["weight"] = torch.ones(c, device=dev)
            params["bias"] = torch.zeros(c, device=dev)
        state = {}
        if self.track_running_stats:
            state["running_mean"] = torch.zeros(c, device=dev)
            state["running_var"] = torch.ones(c, device=dev)
        return params, state

    def apply(self, params, state, x, *, training=True, z=None):
        weight = params.get("weight") if self.affine else None
        bias = params.get("bias") if self.affine else None
        rm = state.get("running_mean") if self.track_running_stats else None
        rv = state.get("running_var") if self.track_running_stats else None
        out, new_rm, new_rv = sync_batch_norm(
            x, weight, bias, rm, rv, axis_name=self.axis_name,
            training=training, momentum=self.momentum, eps=self.eps,
            channel_last=self.channel_last, fuse_relu=self.fuse_relu, z=z)
        new_state = dict(state)
        if self.track_running_stats and training:
            new_state = {"running_mean": new_rm, "running_var": new_rv}
        return out, new_state
