"""FusedAdagrad: h += g²; p -= lr·g / (√h + eps), with L2 weight decay
folded into the gradient.

Counterpart of ``apex_tpu/optimizers/fused_adagrad.py`` (the reference's
``multi_tensor_adagrad.cu``).  ``impl="xla"`` is the per-leaf tree math;
``impl="fused"`` the flat engine, whose ``step_flat`` is elementwise
PyTorch over the flat fp32 buffers, as the JAX package's is one XLA
fusion (no Pallas kernel).  Every step returns a new state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ._base import FusedOptimizer, lr_tensor, resolve, tree_zeros_f32
from ..utils.device import from_numpy
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["FusedAdagrad", "FusedAdagradState", "adagrad_state_from_jax"]


class FusedAdagradState(NamedTuple):
    count: torch.Tensor   # 0-d int32: steps taken
    h: Any                # tree (xla) or flat buffer (fused)
    master: Any = None    # fused impl: flat fp32 master params


class FusedAdagrad(FusedOptimizer):

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0,
                 set_grad_none=True, impl="xla"):
        # set_grad_none: accepted for the signature; nothing to clear
        super().__init__(lr, weight_decay, impl)
        self.eps = eps

    def init(self, params) -> FusedAdagradState:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.impl == "fused":
            fl = self.flattener_for(params)
            return FusedAdagradState(
                count, torch.zeros(fl.total, device=device),
                fl.flatten(params))
        return FusedAdagradState(count, tree_zeros_f32(params))

    def _lr(self, state, lr):
        count = state.count + 1
        lr = resolve(lr if lr is not None else self.lr, count)
        return count, lr_tensor(lr, count.device)

    def _update(self, g, p, h, lr):
        """(new p, new h) from the scaled fp32 gradient."""
        g = g + self.weight_decay * p
        h = h + g * g
        return p - lr * g / (torch.sqrt(h) + self.eps), h

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        """Adagrad over the flat buffers: a new state whose ``master`` holds
        the updated flat fp32 params."""
        count, lr = self._lr(state, lr)
        p, h = self._update(flat_grads.float() * (1.0 / float(scale)),
                            state.master, state.h, lr)
        return FusedAdagradState(count, h, p)

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

        def upd(g, p, h):
            p_new, h_new = self._update(g.float() * inv_scale, p.float(), h,
                                        lr)
            return p_new.to(p.dtype), h_new

        g_l, treedef = tree_flatten(grads)
        outs = [upd(*xs) for xs in zip(g_l, tree_leaves(params),
                                       tree_leaves(state.h))]
        new_params, new_h = (tree_unflatten(treedef, [o[i] for o in outs])
                             for i in range(2))
        return new_params, FusedAdagradState(count, new_h)


def adagrad_state_from_jax(state, device=None) -> FusedAdagradState:
    """The JAX package's ``FusedAdagradState`` (fields as numpy arrays, or
    anything ``np.asarray`` takes; h flat or a tree) -> the port's, on
    ``device`` (default ``"cuda"``)."""
    return FusedAdagradState(*from_numpy(tuple(state), device))
