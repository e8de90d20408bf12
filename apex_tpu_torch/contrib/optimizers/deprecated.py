"""The deprecated contrib optimizer API (counterpart of
``apex_tpu/contrib/optimizers/deprecated.py``; the reference's
``apex/contrib/optimizers/fused_adam.py`` / ``fused_lamb.py`` /
``fused_sgd.py``, whose ``step`` takes ``grads=``, ``output_params=`` and
``scale=`` explicitly).

Thin stateful facades over the port's :class:`~apex_tpu_torch.optimizers.
FusedAdam`, :class:`~apex_tpu_torch.optimizers.FusedLAMB` and
:class:`~apex_tpu_torch.optimizers.FusedSGD`, for scripts written against
the deprecated API.  Each warns with a ``DeprecationWarning`` naming its
replacement, as the reference does.
"""
from __future__ import annotations

import warnings
from typing import Any

import torch

from ...optimizers import FusedAdam as _ModernAdam
from ...optimizers import FusedLAMB as _ModernLAMB
from ...optimizers import FusedSGD as _ModernSGD
from ...optimizers import global_l2norm
from ...utils.pytree import tree_map

__all__ = ["FusedAdam", "FusedLAMB", "FusedSGD"]


class _DeprecatedFacade:
    _modern_cls: Any = None
    _replacement = ""
    _max_grad_norm = 0.0

    def __init__(self, params, **kw):
        warnings.warn(
            f"apex_tpu_torch.contrib.optimizers.{type(self).__name__} is "
            f"deprecated (as in the reference); use {self._replacement}",
            DeprecationWarning, stacklevel=3)   # past the subclass __init__
        self._params = params
        self.optimizer = self._modern_cls(**kw)
        self.state = self.optimizer.init(params)

    def step(self, grads=None, output_params=None, scale=1.0,
             grad_norms=None):
        """The deprecated step: explicit ``grads`` (required: there is no
        ``.grad`` to read), an optional ``output_params`` (a dtype, or a
        tensor whose dtype the returned params take) and ``scale``
        dividing the gradients.  ``grad_norms`` (precomputed norms) is not
        supported: the facade computes the norm itself when
        ``max_grad_norm`` is set.  Returns the new params."""
        if grads is None:
            raise ValueError("the deprecated API requires step(grads=...)")
        if grad_norms is not None:
            raise NotImplementedError(
                "step(grad_norms=...) is unsupported; the facade computes "
                "norms itself when max_grad_norm is set")
        if self._max_grad_norm and self._max_grad_norm > 0:
            # the deprecated Adam folds the global-norm clip into the update
            # scale (the reference's combined_scale); LAMB clips inside
            gnorm = global_l2norm(grads) / scale
            clip = torch.clamp(gnorm / self._max_grad_norm, min=1.0)
            scale = scale * clip
        new_params, self.state = self.optimizer.step(
            self.state, grads, self._params, scale=scale)
        self._params = new_params
        if output_params is not None:
            out_dtype = getattr(output_params, "dtype", output_params)
            return tree_map(lambda p: p.to(out_dtype), new_params)
        return new_params

    @property
    def params(self):
        return self._params

    def state_dict(self):
        return {"params": self._params, "state": self.state}

    def load_state_dict(self, d):
        self._params = d["params"]
        self.state = d["state"]


class FusedAdam(_DeprecatedFacade):
    """The deprecated contrib FusedAdam: classic L2 decay
    (``adam_w_mode=False``) and the clip folded into the scale."""
    _modern_cls = _ModernAdam
    _replacement = "apex_tpu_torch.optimizers.FusedAdam"

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-8, eps_inside_sqrt=False,
                 weight_decay=0.0, max_grad_norm=0.0, amsgrad=False,
                 use_mt=False, amp_scale_adjustment=1.0):
        if amsgrad:
            raise RuntimeError(
                "FusedAdam does not support the AMSGrad variant.")
        if eps_inside_sqrt:
            # sqrt(v + eps) is another denominator, not a launch knob
            raise NotImplementedError(
                "eps_inside_sqrt=True is not implemented; use the default "
                "eps mode")
        del use_mt, amp_scale_adjustment   # launch-latency knobs: no-op
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, weight_decay=weight_decay,
                         adam_w_mode=False)
        self._max_grad_norm = max_grad_norm


class FusedLAMB(_DeprecatedFacade):
    """The deprecated contrib FusedLAMB."""
    _modern_cls = _ModernLAMB
    _replacement = "apex_tpu_torch.optimizers.FusedLAMB"

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support AMSGrad")
        super().__init__(params, lr=lr, bias_correction=bias_correction,
                         betas=betas, eps=eps, weight_decay=weight_decay,
                         adam_w_mode=adam_w_mode,
                         grad_averaging=grad_averaging,
                         max_grad_norm=max_grad_norm, use_nvlamb=use_nvlamb)


class FusedSGD(_DeprecatedFacade):
    """The deprecated contrib FusedSGD."""
    _modern_cls = _ModernSGD
    _replacement = "apex_tpu_torch.optimizers.FusedSGD"

    def __init__(self, params, lr, momentum=0.0, dampening=0.0,
                 weight_decay=0.0, nesterov=False, wd_after_momentum=False,
                 materialize_master_grads=True):
        del materialize_master_grads
        super().__init__(params, lr=lr, momentum=momentum,
                         dampening=dampening, weight_decay=weight_decay,
                         nesterov=nesterov,
                         wd_after_momentum=wd_after_momentum)
