"""FusedLAMB: layer-wise adaptive large-batch optimizer.

Counterpart of ``apex_tpu/optimizers/fused_lamb.py``: global-grad-norm
clipping (``max_grad_norm``), per-tensor trust ratios, AdamW-style decoupled
decay.  ``impl="xla"`` is the per-leaf tree math; ``impl="fused"`` is the
flat engine: the clip's global norm comes from the l2norm kernel
(:func:`~apex_tpu_torch.multi_tensor_apply.multi_tensor_l2norm`), stage 1
(m, v, the update direction) is elementwise PyTorch over the flat buffers,
and stage 2 scales each tensor's update by its trust ratio, taken from the
flattener's per-tensor sums and broadcast by row.  The flat update returns
new buffers; it does not write into the state it was given.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ._base import FusedOptimizer, global_l2norm, tree_zeros_f32
from ..multi_tensor_apply.flattener import LANE
from ..multi_tensor_apply.kernels import multi_tensor_l2norm
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["FusedLAMB", "FusedLAMBState"]


class FusedLAMBState(NamedTuple):
    count: torch.Tensor   # 0-d int32: steps taken
    m: Any
    v: Any
    master: Any = None    # fused impl: flat fp32 master params


class FusedLAMB(FusedOptimizer):

    # the trust ratios are per-tensor reductions: step_flat_shard below
    elementwise_flat_update = False

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, amsgrad=False,
                 adam_w_mode=True, grad_averaging=True, set_grad_none=True,
                 max_grad_norm=1.0, use_nvlamb=False, impl="xla",
                 state_dtype=None):
        super().__init__(lr, weight_decay, impl, state_dtype)
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support AMSGrad.")
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        # use_nvlamb: apply the trust ratio even when weight_decay == 0
        self.use_nvlamb = use_nvlamb

    def init(self, params) -> FusedLAMBState:
        device = tree_leaves(params)[0].device
        count = torch.zeros((), dtype=torch.int32, device=device)
        if self.impl == "fused":
            fl = self.flattener_for(params)
            return FusedLAMBState(
                count,
                torch.zeros(fl.total, dtype=self.state_dtype, device=device),
                torch.zeros(fl.total, dtype=self.state_dtype, device=device),
                fl.flatten(params))
        return FusedLAMBState(count, tree_zeros_f32(params),
                              tree_zeros_f32(params))

    def _clip_coeff(self, gnorm: torch.Tensor) -> torch.Tensor:
        """1 / max(1, gnorm / max_grad_norm)."""
        if self.max_grad_norm is None or self.max_grad_norm <= 0:
            return torch.ones((), dtype=torch.float32, device=gnorm.device)
        return 1.0 / torch.clamp(gnorm / self.max_grad_norm, min=1.0)

    def step(self, state, grads, params, *, scale=1.0, lr=None):
        if self.impl == "fused":
            fl = self.flattener_for(params)
            new_state = self.step_flat(state, fl.flatten(grads), scale=scale,
                                       lr=lr)
            return fl.unflatten(new_state.master), new_state

        count, lr, rc1, rc2 = self._prep(state, lr)
        inv_scale = 1.0 / float(scale)
        wd = self.weight_decay
        b1, b2, eps = self.beta1, self.beta2, self.eps
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0

        gnorm = global_l2norm(grads) * inv_scale
        clip = self._clip_coeff(gnorm)

        def upd(g, p, m, v):
            g = g.float() * inv_scale * clip
            p32 = p.float()
            if not self.adam_w_mode:
                g = g + wd * p32
            m_new = b1 * m + beta3 * g
            v_new = b2 * v + (1.0 - b2) * g * g
            u = (m_new * rc1) / (torch.sqrt(v_new * rc2) + eps)
            if self.adam_w_mode:
                u = u + wd * p32
            w_norm = torch.sqrt((p32 * p32).sum())
            u_norm = torch.sqrt((u * u).sum())
            ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                                torch.ones_like(w_norm))
            if not self.use_nvlamb and self.weight_decay == 0.0:
                ratio = torch.ones_like(ratio)
            return (p32 - lr * ratio * u).to(p.dtype), m_new, v_new

        g_l, treedef = tree_flatten(grads)
        outs = [upd(*xs) for xs in zip(g_l, tree_leaves(params),
                                       tree_leaves(state.m),
                                       tree_leaves(state.v))]
        new_params, new_m, new_v = (tree_unflatten(treedef, [o[i] for o in outs])
                                    for i in range(3))
        return new_params, FusedLAMBState(count, new_m, new_v)

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        """Flat two-stage LAMB over the permanently flat buffers: the
        global norm of the raw grads from the l2norm kernel, unscale and
        clip folded into one scalar, then :meth:`_flat_update`."""
        count, lr, rc1, rc2 = self._prep(state, lr)
        inv_scale = 1.0 / float(scale)
        gnorm = multi_tensor_l2norm(flat_grads) * inv_scale
        g = flat_grads.float() * (inv_scale * self._clip_coeff(gnorm))
        return self._flat_update(state, g, self.flattener, count, lr, rc1,
                                 rc2)

    def step_flat_shard(self, state, g_shard, *, shard, scale=1.0, lr=None):
        """Sharded two-stage LAMB (weight-update sharding): the chain of
        :meth:`step_flat` on this rank's slice, the global norm and the
        per-tensor norms taken across shards from ``shard`` (a
        :class:`~apex_tpu_torch.parallel.weight_update.ShardContext`)."""
        count, lr, rc1, rc2 = self._prep(state, lr)
        inv_scale = 1.0 / float(scale)
        gnorm = torch.sqrt(shard.global_sumsq(g_shard)) * inv_scale
        g = g_shard.float() * (inv_scale * self._clip_coeff(gnorm))
        return self._flat_update(state, g, shard, count, lr, rc1, rc2)

    def _flat_update(self, state, g, reducer, count, lr, rc1, rc2):
        """Stage 1 + 2 over flat buffers (whole or one shard); ``g`` is the
        unscaled, clipped fp32 gradient buffer; ``reducer`` gives
        ``per_tensor_sumsq`` and ``broadcast_rows`` over the whole model
        (the flattener, or the shard context): one chain for both."""
        wd = self.weight_decay
        b1, b2, eps = self.beta1, self.beta2, self.eps
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0
        p = state.master
        if not self.adam_w_mode:
            g = g + wd * p
        m = b1 * state.m.float() + beta3 * g
        v = b2 * state.v.float() + (1.0 - b2) * g * g
        u = (m * rc1) / (torch.sqrt(v * rc2) + eps)
        if self.adam_w_mode:
            u = u + wd * p

        w_norm = torch.sqrt(reducer.per_tensor_sumsq(p))
        u_norm = torch.sqrt(reducer.per_tensor_sumsq(u))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        if not self.use_nvlamb and self.weight_decay == 0.0:
            ratio = torch.ones_like(ratio)
        ratio_rows = reducer.broadcast_rows(ratio)
        p_new = (p.view(-1, LANE)
                 - lr * ratio_rows[:, None] * u.view(-1, LANE))
        return FusedLAMBState(count, self._store_moment(m),
                              self._store_moment(v), p_new.view(-1))
