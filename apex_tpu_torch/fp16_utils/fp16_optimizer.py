"""The legacy ``FP16_Optimizer`` (counterpart of
``apex_tpu/fp16_utils/fp16_optimizer.py``, the reference's
``fp16_optimizer.py``).

Wraps any of the port's optimizers with fp32 master weights (one per
leaf) and loss scaling, for scripts of the pre-amp API.  A stateful facade
over :mod:`apex_tpu_torch.amp.scaler`: the reference's ``backward`` /
``update_master_grads`` / ``clip_master_grads`` / ``step`` flow becomes
:meth:`FP16_Optimizer.scale_loss` (differentiate its result), then
:meth:`~FP16_Optimizer.update_master_grads` and :meth:`~FP16_Optimizer.
step`, or one ``step(scaled_grads)``.
"""
from __future__ import annotations

import torch

from ..amp import scaler as _scaler
from ..optimizers._base import global_l2norm
from ..utils import pytree as _pt

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    """``init_optimizer`` steps the fp32 masters of ``model_params`` (a
    tree); the scaler's state lives on the params' device.  ``overflow``
    tells whether the last step was skipped."""

    def __init__(self, init_optimizer, model_params, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=True):
        del verbose
        self.optimizer = init_optimizer
        self.model_params = model_params
        self.master_params = _pt.master_params_from(model_params)
        self.opt_state = init_optimizer.init(self.master_params)
        device = _pt.tree_leaves(model_params)[0].device
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            self.scaler_state = _scaler.init(
                "dynamic", init_scale=args.get("init_scale", 2.0 ** 32),
                scale_window=args.get("scale_window", 1000), device=device)
        else:
            self.scaler_state = _scaler.init(static_loss_scale,
                                             device=device)
        self.overflow = False
        self._staged = None   # (grads32, finite) from update_master_grads

    @property
    def loss_scale(self):
        return float(self.scaler_state.loss_scale)

    def scale_loss(self, loss):
        """In place of ``optimizer.backward(loss)``: the scaled loss, to
        differentiate."""
        return _scaler.scale_loss(self.scaler_state, loss)

    def update_master_grads(self, scaled_grads):
        """The staged unscale: scaled model gradients -> fp32 master
        gradients, with the overflow check.  Returns the fp32 gradients
        (clip them and pass them to ``step(grads32=...)``, or call ``step()``
        to apply them as they are)."""
        grads32, finite = _scaler.unscale(self.scaler_state, scaled_grads)
        self._staged = (grads32, finite)
        self.overflow = not bool(finite)
        return grads32

    def step(self, scaled_grads=None, closure=None, grads32=None):
        """Unscale, update and copy the masters to the model; returns the
        new model params.  Three call shapes:

        - ``step(scaled_grads)``: one shot (unscale + update);
        - ``update_master_grads(sg)`` [+ a clip] then ``step()`` or
          ``step(grads32=clipped)``: the staged legacy flow;
        - ``step(closure=fn)``: ``fn() -> scaled_grads`` evaluated again
          after each overflow with the halved scale, at most 20 times (a
          static scale cannot change: one non-finite evaluation skips the
          step).
        """
        if closure is not None:
            self._staged = None
            for _ in range(20):
                grads32_c, finite = _scaler.unscale(self.scaler_state,
                                                    closure())
                if bool(finite) or not self.scaler_state.dynamic:
                    return self._apply(grads32_c, finite)
                # record the overflow (halves the scale) and retry
                self.scaler_state = _scaler.update(self.scaler_state, finite)
                self.overflow = True
            raise FloatingPointError(
                "FP16_Optimizer.step(closure): gradients still non-finite "
                "after 20 loss-scale reductions")
        if grads32 is not None:            # staged + externally clipped
            # check the tensors being applied, not a stale staged flag
            self._staged = None
            return self._apply(grads32, _scaler.all_finite(grads32))
        if scaled_grads is None:           # no-arg: consume staged grads
            if self._staged is None:
                raise RuntimeError(
                    "step() without grads requires a prior "
                    "update_master_grads(scaled_grads)")
            grads32, finite = self._staged
            self._staged = None
            return self._apply(grads32, finite)
        self._staged = None                # one shot: drop a stale stage
        grads32, finite = _scaler.unscale(self.scaler_state, scaled_grads)
        return self._apply(grads32, finite)

    def _apply(self, grads32, finite):
        new_masters, new_state = self.optimizer.step(
            self.opt_state, grads32, self.master_params)
        self.master_params = _scaler.apply_if_finite(finite, new_masters,
                                                     self.master_params)
        self.opt_state = _scaler.apply_if_finite(finite, new_state,
                                                 self.opt_state)
        self.scaler_state = _scaler.update(self.scaler_state, finite)
        self.model_params = _pt.master_to_model(self.master_params,
                                                self.model_params)
        self.overflow = not bool(finite)
        return self.model_params

    def clip_master_grads(self, grads, max_norm):
        """Global-norm clip of fp32 gradients: (clipped grads, norm)."""
        norm = global_l2norm(grads)
        coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return _pt.tree_map(lambda g: g * coef, grads), norm

    def state_dict(self):
        return {
            "loss_scaler": _scaler.state_dict(self.scaler_state),
            "overflow": self.overflow,
            "master_params": self.master_params,
            "opt_state": self.opt_state,
        }

    def load_state_dict(self, d):
        device = self.scaler_state.loss_scale.device
        self.scaler_state = _scaler.load_state_dict(d["loss_scaler"],
                                                    device=device)
        self.overflow = d["overflow"]
        self.master_params = d["master_params"]
        self.opt_state = d["opt_state"]
        self.model_params = _pt.master_to_model(self.master_params,
                                                self.model_params)
