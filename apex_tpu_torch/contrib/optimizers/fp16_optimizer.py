"""The contrib FP16_Optimizer: fp16 model weights, flat fp32 master
weights, dynamic loss scaling, for FUSED optimizers only.

Counterpart of ``apex_tpu/contrib/optimizers/fp16_optimizer.py``::

    opt = FP16_Optimizer(FusedAdam(lr=1e-3, impl="fused"), params16,
                         dynamic_loss_scale=True)
    scaled = opt.scale_loss(loss)        # gradients of `scaled` ...
    params16 = opt.step(scaled_grads)    # ... unscaled, checked, applied

A step packs the scaled gradients into the flat fp32 layout, unscales them
with the overflow flag in one pass of the ``multi_tensor_scale`` kernel
(``1 / loss_scale`` stays on the card), runs the optimizer's
``step_flat``, keeps the old state wherever the flag is set (a
``torch.where`` over every field, the step count included), updates the
loss scale and returns the model copies in their own dtypes.  One host
read a step: ``overflow``, as in the JAX package.
"""
from __future__ import annotations

import torch

from ...amp import scaler as _scaler
from ...multi_tensor_apply.kernels import multi_tensor_scale
from ...optimizers._base import global_l2norm
from ...utils.pytree import tree_leaves, tree_map

__all__ = ["FP16_Optimizer"]


class FP16_Optimizer:
    def __init__(self, init_optimizer, model_params, static_loss_scale=1.0,
                 dynamic_loss_scale=False, dynamic_loss_args=None,
                 verbose=False):
        if init_optimizer.impl != "fused":
            raise ValueError(
                "contrib FP16_Optimizer wraps FUSED optimizers only; pass "
                "impl='fused'")
        self.optimizer = init_optimizer
        # the flat fp32 master and moments live in the fused state
        self.opt_state = init_optimizer.init(model_params)
        self.device = tree_leaves(model_params)[0].device
        args = dynamic_loss_args or {}
        if dynamic_loss_scale:
            self.scaler_state = _scaler.init(
                "dynamic", init_scale=args.get("init_scale", 2.0 ** 16),
                scale_window=args.get("scale_window", 2000),
                device=self.device)
        else:
            self.scaler_state = _scaler.init(static_loss_scale,
                                             device=self.device)
        self.overflow = False

    @property
    def loss_scale(self) -> float:
        return float(self.scaler_state.loss_scale)

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return _scaler.scale_loss(self.scaler_state, loss)

    def step(self, scaled_grads):
        """Flat unscale + overflow flag, the fused update, the skip-select
        and the scale update; returns the new model params."""
        flat_scaled = self.optimizer.flattener.flatten(scaled_grads)
        flat_g32, of_flag = multi_tensor_scale(
            flat_scaled, 1.0 / self.scaler_state.loss_scale)
        finite = of_flag == 0
        new_state = self.optimizer.step_flat(self.opt_state, flat_g32)
        self.opt_state = type(new_state)(*(
            torch.where(finite, n, o)
            for n, o in zip(new_state, self.opt_state)))
        self.scaler_state = _scaler.update(self.scaler_state, finite)
        self.overflow = not bool(finite)
        return self.model_params()

    def model_params(self):
        """The model-precision params from the flat master."""
        return self.optimizer.model_params(self.opt_state)

    def clip_master_grads(self, grads, max_norm):
        """(grads scaled to a global norm of at most ``max_norm``, the norm
        before)."""
        norm = global_l2norm(grads)
        coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        return tree_map(lambda g: g * coef, grads), norm

    def state_dict(self):
        return {"loss_scaler": _scaler.state_dict(self.scaler_state),
                "overflow": self.overflow,
                "opt_state": self.opt_state}

    def load_state_dict(self, d):
        self.scaler_state = _scaler.load_state_dict(d["loss_scaler"],
                                                    device=self.device)
        self.overflow = d["overflow"]
        self.opt_state = d["opt_state"]
