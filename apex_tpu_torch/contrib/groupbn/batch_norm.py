"""BatchNorm2d_NHWC: the groupbn module API over
:func:`~apex_tpu_torch.parallel.sync_batch_norm`.

Counterpart of ``apex_tpu/contrib/groupbn/batch_norm.py``.  The groupbn
surface is kept: ``fuse_relu``, the fused residual input (``z``, added
before the ReLU) and ``bn_group``, whose statistics are summed over a
process group of ``bn_group`` consecutive ranks
(:func:`~apex_tpu_torch.parallel.create_syncbn_process_group`) in place of
the reference's CUDA-IPC peer buffers.  The occupancy knobs
(``max_cta_per_sm``, ``cta_launch_margin``, ``multi_stream``) are accepted
and ignored, as in the JAX module.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ...parallel.sync_batchnorm import sync_batch_norm
from ...utils.device import resolve_device

__all__ = ["BatchNorm2d_NHWC", "bn_nhwc", "bn_add_relu_nhwc"]


def bn_nhwc(x, scale, bias, mean, var, *, axis_name=None, training=True,
            momentum=0.1, eps=1e-5, fuse_relu=False):
    """Functional NHWC batch norm (``bn_NHWC_impl``)."""
    return sync_batch_norm(x, scale, bias, mean, var, axis_name=axis_name,
                           training=training, momentum=momentum, eps=eps,
                           channel_last=True, fuse_relu=fuse_relu)


def bn_add_relu_nhwc(x, z, scale, bias, mean, var, *, axis_name=None,
                     training=True, momentum=0.1, eps=1e-5):
    """Fused batch norm + residual add + ReLU (``bn_addrelu_NHWC_impl``)."""
    return sync_batch_norm(x, scale, bias, mean, var, axis_name=axis_name,
                           training=training, momentum=momentum, eps=eps,
                           channel_last=True, fuse_relu=True, z=z)


class BatchNorm2d_NHWC:
    """Module mirror of groupbn's ``BatchNorm2d_NHWC``.

    ``bn_group > 1`` sums the statistics over this rank's group of
    ``bn_group`` consecutive ranks (made at the first ``apply`` that needs
    it, by every rank: ``new_group`` is collective); 1 leaves the scope to
    ``apply``'s ``axis_name`` (None: the default group when one is
    initialised, else per-device statistics)."""

    def __init__(self, num_features: int, fuse_relu: bool = False,
                 bn_group: int = 1, max_cta_per_sm: int = 2,
                 cta_launch_margin: int = 12, multi_stream: bool = False,
                 momentum: float = 0.1, eps: float = 1e-5):
        del max_cta_per_sm, cta_launch_margin, multi_stream  # no-op knobs
        self.num_features = num_features
        self.fuse_relu = fuse_relu
        self.bn_group = bn_group
        self.momentum = momentum
        self.eps = eps
        self._group = None

    def init(self, device=None):
        """(params, state): scale / bias and the running statistics, fp32
        on ``device`` (default ``"cuda"``)."""
        dev = resolve_device(device)
        c = self.num_features
        params = {"scale": torch.ones(c, device=dev),
                  "bn_bias": torch.zeros(c, device=dev)}
        state = {"mean": torch.zeros(c, device=dev),
                 "var": torch.ones(c, device=dev)}
        return params, state

    def _bn_group(self):
        if self._group is None and dist.is_initialized():
            from ...parallel import create_syncbn_process_group
            self._group = create_syncbn_process_group(self.bn_group)
        return self._group

    def apply(self, params, state, x, z=None, *, training=True,
              axis_name=None):
        """x (N, H, W, C); optional residual ``z`` (added before the ReLU).
        Returns (out, new_state)."""
        if axis_name is None and self.bn_group > 1:
            axis_name = self._bn_group()
        out, mean, var = sync_batch_norm(
            x, params["scale"], params["bn_bias"], state["mean"],
            state["var"], axis_name=axis_name, training=training,
            momentum=self.momentum, eps=self.eps, channel_last=True,
            fuse_relu=self.fuse_relu or z is not None, z=z)
        return out, ({"mean": mean, "var": var} if training else state)

    __call__ = apply
