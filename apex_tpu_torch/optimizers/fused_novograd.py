"""FusedNovoGrad: NovoGrad, whose second moment is one scalar per tensor.

Counterpart of ``apex_tpu/optimizers/fused_novograd.py`` (the reference's
``multi_tensor_novograd.cu``), with its knobs: ``norm_type`` 2 (the
squared L2 norm per tensor) or 0 (the max-abs norm), ``reg_inside_moment``,
``grad_averaging``, ``init_zero`` (v starts at 0 and is blended in the
first step too; otherwise the first step's norm is v) and
``bias_correction``.  ``impl="xla"`` is the per-leaf tree math;
``impl="fused"`` the flat engine: the per-tensor norms are the flattener's
row-range reductions (``per_tensor_sumsq`` / ``per_tensor_maxabs``), v a
(num_leaves,) vector broadcast back by row, the rest elementwise PyTorch
over the flat buffers, as the JAX package's is XLA (no Pallas kernel).
Every step returns a new state.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ._base import FusedOptimizer, lr_tensor, resolve, tree_zeros_f32
from ..multi_tensor_apply.flattener import LANE
from ..utils.device import from_numpy
from ..utils.pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["FusedNovoGrad", "FusedNovoGradState", "novograd_state_from_jax"]


class FusedNovoGradState(NamedTuple):
    count: torch.Tensor   # 0-d int32: steps taken
    m: Any                # tree of fp32 like params (xla) or flat (fused)
    v: Any                # tree of 0-d fp32 (xla) or (num_leaves,) (fused)
    master: Any = None    # fused impl: flat fp32 master params


class FusedNovoGrad(FusedOptimizer):

    # v is a per-tensor norm: step_flat_shard below
    elementwise_flat_update = False

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.95, 0.98),
                 eps=1e-8, weight_decay=0.0, amsgrad=False,
                 reg_inside_moment=False, grad_averaging=True, norm_type=2,
                 init_zero=False, set_grad_none=True, impl="xla"):
        # set_grad_none: accepted for the signature; nothing to clear
        super().__init__(lr, weight_decay, impl)
        if amsgrad:
            raise RuntimeError("FusedNovoGrad does not support AMSGrad.")
        if norm_type not in (2, 0):
            raise ValueError("norm_type must be 2 (L2) or 0 (inf)")
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.reg_inside_moment = reg_inside_moment
        self.grad_averaging = grad_averaging
        self.norm_type = norm_type
        self.init_zero = init_zero

    def init(self, params) -> FusedNovoGradState:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.impl == "fused":
            fl = self.flattener_for(params)
            return FusedNovoGradState(
                count, torch.zeros(fl.total, device=device),
                torch.zeros(fl.num_leaves, device=device),
                fl.flatten(params))
        return FusedNovoGradState(
            count, tree_zeros_f32(params),
            tree_map(lambda p: torch.zeros((), device=p.device), params))

    def _prep_step(self, state, lr):
        """(count, lr, first, 1 / (1 - beta1^t) or None)."""
        count = state.count + 1
        lr = resolve(lr if lr is not None else self.lr, count)
        lr = lr_tensor(lr, count.device)
        rc1 = None
        if self.bias_correction:
            rc1 = 1.0 - torch.pow(self.beta1, count.float())
        return count, lr, state.count == 0, rc1

    def _v_and_denom(self, norm_val, v, first):
        """The new per-tensor v from this step's norm (||g||^2 or max|g|),
        and the denominator it gives."""
        b2 = self.beta2
        ema = b2 * v + (1.0 - b2) * norm_val
        v_new = torch.where(first & (not self.init_zero), norm_val, ema)
        denom = (torch.sqrt(v_new) + self.eps if self.norm_type == 2
                 else v_new + self.eps)
        return v_new, denom

    def _moment(self, gn, p, m, lr, rc1):
        """(new p, new m) from the normalized gradient ``gn``."""
        wd, b1 = self.weight_decay, self.beta1
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0
        if self.reg_inside_moment:
            gn = gn + wd * p
        m_new = b1 * m + beta3 * gn
        u = m_new if self.reg_inside_moment else m_new + wd * p
        if rc1 is not None:
            u = u / rc1
        return p - lr * u, m_new

    def step(self, state, grads, params, *, scale=1.0, lr=None):
        """One update; ``scale`` divides the gradients (amp's loss scale).
        Returns (new_params, new_state)."""
        if self.impl == "fused":
            fl = self.flattener_for(params)
            new_state = self.step_flat(state, fl.flatten(grads), scale=scale,
                                       lr=lr)
            return fl.unflatten(new_state.master), new_state

        count, lr, first, rc1 = self._prep_step(state, lr)
        inv_scale = 1.0 / float(scale)

        def upd(g, p, m, v):
            g = g.float() * inv_scale
            p32 = p.float()
            if self.norm_type == 2:
                gnorm = torch.sqrt(torch.sum(g * g))
                norm_val = gnorm * gnorm
            else:
                norm_val = torch.amax(torch.abs(g))
            v_new, denom = self._v_and_denom(norm_val, v, first)
            p_new, m_new = self._moment(g / denom, p32, m, lr, rc1)
            return p_new.to(p.dtype), m_new, v_new

        g_l, treedef = tree_flatten(grads)
        outs = [upd(*xs) for xs in zip(g_l, tree_leaves(params),
                                       tree_leaves(state.m),
                                       tree_leaves(state.v))]
        new_params, new_m, new_v = (
            tree_unflatten(treedef, [o[i] for o in outs]) for i in range(3))
        return new_params, FusedNovoGradState(count, new_m, new_v)

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        """NovoGrad over the flat buffers: the per-tensor norms from the
        flattener's static row ranges, then one elementwise chain; a new
        state whose ``master`` holds the updated flat fp32 params."""
        return self._flat_update(state, flat_grads, self.flattener,
                                 scale=scale, lr=lr)

    def step_flat_shard(self, state, g_shard, *, shard, scale=1.0, lr=None):
        """Sharded NovoGrad (weight-update sharding): the chain of
        :meth:`step_flat` on this rank's slice of ``m`` / ``master``; the
        per-tensor ``v`` stays whole on every rank, from the norms ``shard``
        (a :class:`~apex_tpu_torch.parallel.weight_update.ShardContext`)
        takes across shards."""
        return self._flat_update(state, g_shard, shard, scale=scale, lr=lr)

    def _flat_update(self, state, flat_grads, reducer, *, scale, lr):
        """The chain over flat buffers (whole or one shard); ``reducer``
        gives ``per_tensor_sumsq`` / ``per_tensor_maxabs`` /
        ``broadcast_rows`` over the whole model."""
        count, lr, first, rc1 = self._prep_step(state, lr)
        g = flat_grads.float() * (1.0 / float(scale))
        norm_val = (reducer.per_tensor_sumsq(g) if self.norm_type == 2
                    else reducer.per_tensor_maxabs(g))
        v_new, denom = self._v_and_denom(norm_val, state.v, first)
        denom_rows = reducer.broadcast_rows(denom)
        # padding rows broadcast 0: keep 0/0 from seeding NaNs into m
        denom_rows = torch.where(denom_rows > 0, denom_rows,
                                 torch.ones_like(denom_rows))
        gn = (g.view(-1, LANE) / denom_rows[:, None]).reshape(-1)
        p_new, m_new = self._moment(gn, state.master, state.m, lr, rc1)
        return FusedNovoGradState(count, m_new, v_new, p_new)


def novograd_state_from_jax(state, device=None) -> FusedNovoGradState:
    """The JAX package's ``FusedNovoGradState`` (fields as numpy arrays, or
    anything ``np.asarray`` takes; m and v flat or trees) -> the port's, on
    ``device`` (default ``"cuda"``)."""
    return FusedNovoGradState(*from_numpy(tuple(state), device))
