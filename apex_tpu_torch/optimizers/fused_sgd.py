"""FusedSGD: momentum SGD.

Counterpart of ``apex_tpu/optimizers/fused_sgd.py``: momentum, dampening,
nesterov, ``wd_after_momentum`` and the first-step momentum initialisation
(with dampening the buffer starts as the gradient, as torch's does).
``impl="xla"`` is the per-leaf tree math; ``impl="fused"`` the flat engine,
whose ``step_flat`` is elementwise PyTorch over the flat fp32 buffers, as
the JAX package's is one XLA fusion, and which, like it, refuses dampening.
Every step returns a new state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ._base import FusedOptimizer, lr_tensor, resolve, tree_zeros_f32
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["FusedSGD", "FusedSGDState"]


class FusedSGDState(NamedTuple):
    count: torch.Tensor   # 0-d int32: steps taken
    momentum: Any         # tree (xla) or flat buffer (fused)
    master: Any = None    # fused impl: flat fp32 master params


class FusedSGD(FusedOptimizer):

    def __init__(self, lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False, wd_after_momentum=False, impl="xla"):
        super().__init__(lr, weight_decay, impl)
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError(
                "Nesterov momentum requires a momentum and zero dampening")
        self.momentum = momentum
        self.dampening = dampening
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def init(self, params) -> FusedSGDState:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.impl == "fused":
            fl = self.flattener_for(params)
            return FusedSGDState(count, torch.zeros(fl.total, device=device),
                                 fl.flatten(params))
        return FusedSGDState(count, tree_zeros_f32(params))

    def _lr(self, state, lr):
        count = state.count + 1
        lr = resolve(lr if lr is not None else self.lr, count)
        return count, lr_tensor(lr, count.device)

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        """Momentum SGD over the flat buffers: a new state whose ``master``
        holds the updated flat fp32 params."""
        if self.dampening != 0.0:
            raise NotImplementedError(
                "impl='fused' does not support dampening != 0")
        count, lr = self._lr(state, lr)
        wd, mu = self.weight_decay, self.momentum
        g = flat_grads.float() * (1.0 / float(scale))
        p = state.master
        if not self.wd_after_momentum:
            g = g + wd * p
        if mu != 0.0:
            mom = mu * state.momentum + g
            u = g + mu * mom if self.nesterov else mom
        else:
            mom, u = state.momentum, g
        if self.wd_after_momentum:
            u = u + wd * p
        return FusedSGDState(count, mom, p - lr * u)

    def step(self, state, grads, params, *, scale=1.0, lr=None):
        """One update; ``scale`` divides the gradients (amp's loss scale).
        Returns (new_params, new_state)."""
        if self.impl == "fused":
            fl = self.flattener_for(params)
            new_state = self.step_flat(state, fl.flatten(grads), scale=scale,
                                       lr=lr)
            return fl.unflatten(new_state.master), new_state

        count, lr = self._lr(state, lr)
        inv_scale = 1.0 / float(scale)
        wd, mu, damp = self.weight_decay, self.momentum, self.dampening
        first = state.count == 0

        def upd(g, p, buf):
            g = g.float() * inv_scale
            p32 = p.float()
            if not self.wd_after_momentum:
                g = g + wd * p32
            if mu != 0.0:
                new_buf = mu * buf + (1.0 - damp) * g
                if damp != 0.0:
                    new_buf = torch.where(first, g, new_buf)
                u = g + mu * new_buf if self.nesterov else new_buf
            else:
                new_buf, u = buf, g
            if self.wd_after_momentum:
                u = u + wd * p32
            return (p32 - lr * u).to(p.dtype), new_buf

        g_l, treedef = tree_flatten(grads)
        outs = [upd(*xs) for xs in zip(g_l, tree_leaves(params),
                                       tree_leaves(state.momentum))]
        new_params, new_mom = (tree_unflatten(treedef, [o[i] for o in outs])
                               for i in range(2))
        return new_params, FusedSGDState(count, new_mom)
