"""FusedAdam: Adam / AdamW with the multi-tensor fused update.

Counterpart of ``apex_tpu/optimizers/fused_adam.py``: ``adam_w_mode``
(decoupled decay) or classic L2, ``bias_correction``, a gradient ``scale``
for amp, ``model_dtype`` (the new params in that dtype), ``state_dtype``
(moment storage, fused impl) and learning-rate schedules.
``impl="xla"`` is the per-leaf tree math; ``impl="fused"`` is the flat
engine: ``step_flat(state, flat_grads)`` updates the flat fp32 master and
moments as elementwise PyTorch over the flat buffers, as the JAX package
computes it in XLA (the Adam kernel of ``multi_tensor_apply`` serves the
ZeRO optimizer).  Every step returns a new state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ._base import FusedOptimizer, tree_zeros_f32
from ..utils.device import from_numpy
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["FusedAdam", "FusedAdamState", "adam_state_from_jax"]


class FusedAdamState(NamedTuple):
    count: torch.Tensor   # 0-d int32: steps taken
    m: Any                # tree (xla) or flat buffer (fused)
    v: Any
    master: Any = None    # fused impl: flat fp32 master params


class FusedAdam(FusedOptimizer):

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0, amsgrad=False,
                 set_grad_none=True, model_dtype=None, impl="xla",
                 state_dtype=None):
        # set_grad_none: accepted for the signature; nothing to clear
        super().__init__(lr, weight_decay, impl, state_dtype)
        if amsgrad:
            raise RuntimeError("FusedAdam does not support the AMSGrad "
                               "variant.")
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.model_dtype = model_dtype

    def init(self, params) -> FusedAdamState:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.impl == "fused":
            fl = self.flattener_for(params)
            return FusedAdamState(
                count,
                torch.zeros(fl.total, dtype=self.state_dtype, device=device),
                torch.zeros(fl.total, dtype=self.state_dtype, device=device),
                fl.flatten(params))
        return FusedAdamState(count, tree_zeros_f32(params),
                              tree_zeros_f32(params))

    def _update(self, g, p, m, v, rc1, rc2):
        """(direction u, m, v) from the scaled fp32 gradient, in the JAX
        order."""
        wd, b1, b2 = self.weight_decay, self.beta1, self.beta2
        if not self.adam_w_mode:
            g = g + wd * p                # classic L2 (ADAM_MODE_0)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        u = (m * rc1) / (torch.sqrt(v * rc2) + self.eps)
        if self.adam_w_mode:
            u = u + wd * p                # decoupled decay (ADAM_MODE_1)
        return u, m, v

    def step(self, state, grads, params, *, scale=1.0, lr=None):
        """One update; ``scale`` divides the gradients (amp's loss scale).
        Returns (new_params, new_state)."""
        if self.impl == "fused":
            fl = self.flattener_for(params)
            new_state = self.step_flat(state, fl.flatten(grads), scale=scale,
                                       lr=lr)
            return (fl.unflatten(new_state.master, dtype=self.model_dtype),
                    new_state)

        count, lr, rc1, rc2 = self._prep(state, lr)
        inv_scale = 1.0 / float(scale)

        def upd(g, p, m, v):
            p32 = p.float()
            u, m, v = self._update(g.float() * inv_scale, p32, m, v, rc1, rc2)
            return (p32 - lr * u).to(self.model_dtype or p.dtype), m, v

        g_l, treedef = tree_flatten(grads)
        outs = [upd(*xs) for xs in zip(g_l, tree_leaves(params),
                                       tree_leaves(state.m),
                                       tree_leaves(state.v))]
        new_params, new_m, new_v = (
            tree_unflatten(treedef, [o[i] for o in outs]) for i in range(3))
        return new_params, FusedAdamState(count, new_m, new_v)

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        """Adam(W) over the flat buffers: a new state whose ``master`` holds
        the updated flat fp32 params."""
        count, lr, rc1, rc2 = self._prep(state, lr)
        inv_scale = 1.0 / float(scale)
        p = state.master
        u, m, v = self._update(flat_grads.float() * inv_scale, p,
                               state.m.float(), state.v.float(), rc1, rc2)
        return FusedAdamState(count, self._store_moment(m),
                              self._store_moment(v), p - lr * u)


def adam_state_from_jax(state, device=None) -> FusedAdamState:
    """The JAX package's ``FusedAdamState`` (fields as numpy arrays, or
    anything ``np.asarray`` takes; m and v flat or trees) -> the port's, on
    ``device`` (default ``"cuda"``)."""
    return FusedAdamState(*from_numpy(tuple(state), device))
