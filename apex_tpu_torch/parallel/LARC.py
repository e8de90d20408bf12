"""LARC: layer-wise adaptive rate clipping / scaling.

Counterpart of ``apex_tpu/parallel/LARC.py``: wraps any of the port's fused
optimizers and rescales each parameter's gradient by an adaptive local rate
before delegating, so the wrapped optimizer stays unaware of it.  Per
parameter::

    adaptive_lr = trust_coefficient * ||p|| / (||g|| + wd * ||p|| + eps)
    clip=True:  g = (g + wd * p) * min(adaptive_lr / lr, 1)
    clip=False: g = (g + wd * p) * adaptive_lr

The decay is folded into the gradient before the rescale, and the wrapped
optimizer's own decay is suppressed for the step.  A parameter whose norm
or whose gradient's norm is 0 keeps its gradient untouched, decay fold
included.
"""
from __future__ import annotations

import contextlib

import torch

from ..optimizers._base import resolve
from ..utils.pytree import tree_map

__all__ = ["LARC"]


class LARC:
    """Optimizer wrapper::

        opt = LARC(FusedSGD(lr=0.1, momentum=0.9), trust_coefficient=0.02)
        state = opt.init(params)
        params, state = opt.step(state, grads, params)
    """

    def __init__(self, optimizer, trust_coefficient=0.02, clip=True,
                 eps=1e-8):
        self.optim = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def __getattr__(self, name):          # the wrapped optimizer's knobs
        return getattr(self.optim, name)

    def init(self, params):
        return self.optim.init(params)

    @contextlib.contextmanager
    def _suppress_inner_wd(self):
        """The wrapped optimizer's decay is 0 while it steps: the decay is
        already folded into the gradients."""
        wd = getattr(self.optim, "weight_decay", 0.0)
        self.optim.weight_decay = 0.0
        try:
            yield wd
        finally:
            self.optim.weight_decay = wd

    def _adapt(self, grads, params, lr, wd):
        lr = torch.clamp(torch.as_tensor(lr, dtype=torch.float32), min=1e-30)

        def leaf(g, p):
            g32, p32 = g.float(), p.float()
            p_norm = torch.sqrt(torch.sum(p32 * p32))
            g_norm = torch.sqrt(torch.sum(g32 * g32))
            adaptive_lr = (self.trust_coefficient * p_norm
                           / (g_norm + p_norm * wd + self.eps))
            scale = (torch.clamp(adaptive_lr / lr.to(g32.device), max=1.0)
                     if self.clip else adaptive_lr)
            adapted = (g32 + wd * p32) * scale
            ok = (p_norm > 0) & (g_norm > 0)
            return torch.where(ok, adapted, g32).to(g.dtype)

        return tree_map(leaf, grads, params)

    def step(self, state, grads, params, *, lr=None, scale=1.0, **kw):
        # the wrapped optimizer counts the step before resolving a schedule,
        # so clip against the rate this step will use
        count = getattr(state, "count", 0) + 1
        eff_lr = resolve(lr if lr is not None else self.optim.lr, count)
        if not (isinstance(scale, (int, float)) and scale == 1.0):
            # norms are taken on real gradients: unscale here and hand the
            # wrapped optimizer scale 1
            inv = 1.0 / torch.as_tensor(scale, dtype=torch.float32)
            grads = tree_map(lambda g: (g.float() * inv.to(g.device))
                             .to(g.dtype), grads)
        with self._suppress_inner_wd() as wd:
            grads = self._adapt(grads, params, eff_lr, wd)
            return self.optim.step(state, grads, params, lr=lr, **kw)
