"""ZeRO-style sharded data-parallel fused optimizers.

Counterpart of ``apex_tpu/contrib/optimizers/distributed_fused.py``: the
gradients are reduce-scattered so each rank owns ``1/N`` of the flat
gradient, the fp32 master params and both moments live sharded (optimizer
state per rank is ``1/N`` of the model), the fused update runs on the
shard, and the new params are all-gathered back (optionally in bf16).

Where the JAX package binds ``shard_axis`` / ``replica_axis`` inside
``shard_map``, the port runs one process per rank and takes
``torch.distributed`` process groups: ``shard_group`` carries the
reduce-scatter and the all-gather, the optional ``replica_group`` (the
two-level topology) only an all-reduce of the shard.  The step pipeline is
the JAX package's, in its order: predivide, reduce-scatter, the replica
all-reduce, the overflow flag (an all-reduce MIN), the global sum of
squares (an all-reduce over ``shard_group`` only), the clip, stage 1 —
through the ``fused_adam_flat`` / ``fused_lamb_stage1_flat`` kernels with
``impl="fused"``, or the same math as PyTorch ops with ``impl="xla"`` (the
default, as the JAX package resolves it off a TPU) — then LAMB's stage-2
trust ratios from per-shard segment sums, the overflow select (which keeps
the new ``gnorm``), the all-gather and the unflatten.

The stage-2 segment sums use the segments' contiguity: each leaf's row
range clipped to this shard, summed in a fixed order, so the trust ratios
repeat bit for bit (no ``index_add_`` atomics).  Every step returns new
tensors; nothing is updated in place, so a skipped step keeps the old
state.  The gradient reduce-scatter takes every scheme of
:mod:`~apex_tpu_torch.parallel.collectives` (``collective_scheme``: fp32,
bf16, int8_blockscale with the error-feedback ``residual``, adasum), the
param all-gather fp32, bf16 or int8_blockscale (``allgather_scheme``,
``bf16_allgather``); both are metered as ``zero.reduce_scatter`` /
``zero.allgather`` through ``telemetry.events.record_collective``.

Usage, one process per card (``apex_tpu_torch.parallel.
initialize_distributed``)::

    opt = DistributedFusedLAMB(lr=1e-3, impl="fused", bf16_allgather=True)
    state = opt.init(params)            # this rank's shard
    params, state = opt.step(state, local_grads, params)
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ...multi_tensor_apply import kernels
from ...multi_tensor_apply.flattener import LANE, TreeFlattener
from ...optimizers._base import resolve, resolve_state_dtype
from ...parallel import collectives as _coll
from ...parallel.mesh import group_rank, group_size
from ...telemetry import events as _tel_events
from ...utils import tuning
from ...utils.device import resolve_device
from ...utils.pytree import tree_flatten

__all__ = ["ShardedAdamState", "ShardedLAMBState", "DistributedFusedAdam",
           "DistributedFusedLAMB", "state_from_jax"]


class ShardedAdamState(NamedTuple):
    count: torch.Tensor       # () int32
    p: torch.Tensor           # (total/N,) fp32 master shard
    m: torch.Tensor           # (total/N,) state_dtype (fp32 default)
    v: torch.Tensor           # (total/N,) state_dtype (fp32 default)
    gnorm: torch.Tensor       # () last global grad norm


class ShardedLAMBState(NamedTuple):
    count: torch.Tensor
    p: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    gnorm: torch.Tensor


class _ShardPlan(NamedTuple):
    """Where this rank's shard sits in the flat layout."""
    rank: int
    lo: int                              # first element of the shard
    per: int                             # elements in the shard
    rows: Tuple[int, int]                # its rows of the flat buffer


class _DistributedFusedBase:
    """Shared sharded-flat-buffer machinery."""

    def __init__(self, lr, weight_decay=0.0, shard_group=None,
                 replica_group=None, predivide=True, bf16_allgather=False,
                 check_overflow=True, impl=None, state_dtype=None,
                 collective_scheme=None, allgather_scheme=None):
        if impl is None:
            # the tuning profile's zero_impl (on the card only), else the
            # JAX package's built-in, the plain flat update
            impl = tuning.get_on_gpu("zero_impl", "xla")
        if impl not in ("xla", "fused"):
            raise ValueError(f"impl must be 'xla' or 'fused', got {impl!r}")
        self.lr = lr
        self.weight_decay = weight_decay
        self.shard_group = shard_group
        self.replica_group = replica_group
        self.predivide = predivide
        self.bf16_allgather = bf16_allgather
        self.check_overflow = check_overflow
        self.impl = impl
        # narrow m/v storage on the shards; the math and the master stay
        # fp32
        self.state_dtype = resolve_state_dtype(state_dtype)
        self.collective_scheme = collective_scheme
        self.allgather_scheme = allgather_scheme
        self._fl: Optional[TreeFlattener] = None
        self._fl_key = None
        self._plan: Optional[_ShardPlan] = None
        self._consts = {}

    def _store_moment(self, x):
        return x.to(self.state_dtype)

    # -- flat packing --------------------------------------------------------

    def _flattener(self, params, n_shards: int) -> TreeFlattener:
        leaves, treedef = tree_flatten(params)
        key = (treedef, tuple(tuple(l.shape) for l in leaves), n_shards)
        if self._fl is None or self._fl_key != key:
            # chunk = LANE * n_shards: the total splits into n_shards whole
            # runs of 128-element rows
            self._fl = TreeFlattener(params, chunk=LANE * n_shards)
            self._fl_key = key
            self._plan = None
        return self._fl

    def _shard_plan(self, fl: TreeFlattener, n_shards: int) -> _ShardPlan:
        rank = group_rank(self.shard_group)
        if self._plan is None or self._plan.rank != rank:
            rows_per = fl.total // LANE // n_shards
            r_lo = rank * rows_per
            self._plan = _ShardPlan(rank, r_lo * LANE, rows_per * LANE,
                                    (r_lo, r_lo + rows_per))
        return self._plan

    def _world(self) -> int:
        world = group_size(self.shard_group)
        if self.replica_group is not None:
            world *= group_size(self.replica_group)
        return world

    # -- collectives ---------------------------------------------------------

    def _resolve_scheme(self, which):
        """The gradient reduce-scatter's scheme: the constructor's, else
        the live override, else ``APEX_TPU_COLLECTIVES``; the param
        all-gather's: the constructor's only (quantizing params is an
        accuracy trade the ambient knob must not flip)."""
        if which == "ag":
            if self.allgather_scheme is None:
                return None
            return _coll.resolve(self.allgather_scheme, tuning_key=None)
        return _coll.resolve(self.collective_scheme, tuning_key=None)

    def _meter(self, op, logical, wire, seconds, scheme, dtype):
        """One ``zero.<op>`` record a collective, free without a registry
        or tracer."""
        if _tel_events.metering():
            _tel_events.record_collective(
                _coll.axis_label(self.shard_group), int(logical), 1,
                seconds, wire_bytes=int(wire), dtype=dtype, scheme=scheme,
                op=op)

    def _reduce_scatter(self, flat_g, residual=None):
        """Local full flat grads -> this rank's reduced shard: RS over
        ``shard_group``, then an all-reduce over ``replica_group``.  A
        compressed ``collective_scheme`` ships its wire form
        (:func:`~apex_tpu_torch.parallel.collectives.reduce_scatter_flat`)
        with the int8 error-feedback ``residual`` (full flat fp32); the
        replica all-reduce stays fp32.  Returns ``(g_shard,
        new_residual)``."""
        spec = self._resolve_scheme("rs")
        world = self._world()
        t0 = time.perf_counter()
        if spec is None or spec.scheme == "fp32":
            if self.predivide:
                flat_g = flat_g * (1.0 / world)
            g_shard, _ = _coll.reduce_scatter_flat(flat_g, self.shard_group,
                                                   spec)
            if self.replica_group is not None:
                dist.all_reduce(g_shard, op=dist.ReduceOp.SUM,
                                group=self.replica_group)
            if not self.predivide:
                g_shard = g_shard / world
            nbytes = flat_g.numel() * flat_g.element_size()
            self._meter("reduce_scatter", nbytes, nbytes,
                        time.perf_counter() - t0,
                        spec.scheme if spec else None,
                        _coll.dtype_name(flat_g.dtype))
            return g_shard, residual
        info = _coll.get_scheme(spec.scheme)
        x = flat_g.to(torch.float32)
        if self.predivide and not info.self_scaling:
            x = x * (1.0 / world)
        g_shard, new_residual = _coll.reduce_scatter_flat(
            x, self.shard_group, spec, residual=residual,
            label="zero.reduce_scatter")
        if self.replica_group is not None:
            dist.all_reduce(g_shard, op=dist.ReduceOp.SUM,
                            group=self.replica_group)
            if info.self_scaling:
                # adasum across replica groups: the mean of the groups'
                # merges (each carries its own magnitude)
                g_shard = g_shard / group_size(self.replica_group)
        if not self.predivide and not info.self_scaling:
            g_shard = g_shard / world
        self._meter("reduce_scatter", x.numel() * 4,
                    info.wire_bytes(x.numel(), spec.block),
                    time.perf_counter() - t0, spec.scheme, info.wire_dtype)
        return g_shard, new_residual

    def init_residual(self, params):
        """Zero int8 error-feedback residual of the reduce-scatter: full
        flat, fp32, on the params' device; carry it through ``step(...,
        residual=...)``."""
        fl = self._flattener(params, group_size(self.shard_group))
        dev = tree_flatten(params)[0][0].device
        return torch.zeros(fl.total, dtype=torch.float32, device=dev)

    def _allgather(self, p_shard):
        spec = self._resolve_scheme("ag")
        if spec is not None and spec.scheme == "adasum":
            raise ValueError("adasum is a reduction rule; it has no "
                             "allgather meaning")
        if self.bf16_allgather and (spec is None or spec.scheme == "fp32"):
            spec = _coll.CollectiveSpec(scheme="bf16")
        t0 = time.perf_counter()
        full, wire, wdtype = _coll.allgather_flat(
            p_shard, self.shard_group, spec, label="zero.allgather")
        self._meter("allgather", p_shard.numel() * 4, wire,
                    time.perf_counter() - t0,
                    spec.scheme if spec is not None else None, wdtype)
        return full

    def _global_sumsq(self, x_shard):
        """Global sum of squares from the shards, over ``shard_group``
        only: in the two-level topology the shard is already the same on
        every replica."""
        s = (x_shard.float() ** 2).sum()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=self.shard_group)
        return s

    def _finite_flag(self, g_shard):
        """1.0 iff every reduced gradient element is finite (MIN over
        ``shard_group``; an inf anywhere has reached some shard)."""
        ok = torch.isfinite(g_shard).all().to(torch.float32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self.shard_group)
        return ok

    @staticmethod
    def _select(ok, new, old):
        """Overflow skip: keep the old (state, params) wholesale."""
        keep_new = ok > 0
        return type(new)(*(torch.where(keep_new, n, o)
                           for n, o in zip(new, old)))

    # -- step pieces ---------------------------------------------------------

    def _begin(self, state, grads, params, scale, lr, residual):
        """Flatten, reduce-scatter, overflow flag, global norm and the
        step's scalars, all on the params' device."""
        n = group_size(self.shard_group)
        fl = self._flattener(params, n)
        g_shard, new_residual = self._reduce_scatter(fl.flatten(grads),
                                                     residual)
        dev = g_shard.device
        ok = (self._finite_flag(g_shard) if self.check_overflow
              else torch.ones((), dtype=torch.float32, device=dev))
        scale_t = scale.to(dev, torch.float32) if isinstance(
            scale, torch.Tensor) else torch.full((), float(scale),
                                                 dtype=torch.float32,
                                                 device=dev)
        inv_scale = 1.0 / scale_t
        gnorm = torch.sqrt(self._global_sumsq(g_shard)) * inv_scale
        if self.max_grad_norm and self.max_grad_norm > 0:
            clip = 1.0 / torch.clamp(gnorm / self.max_grad_norm, min=1.0)
        else:
            clip = torch.ones((), dtype=torch.float32, device=dev)
        count = state.count + 1
        lr_v = resolve(lr if lr is not None else self.lr, count)
        lr_v = lr_v.to(dev, torch.float32) if isinstance(
            lr_v, torch.Tensor) else torch.full((), float(lr_v),
                                                dtype=torch.float32,
                                                device=dev)
        if self.bias_correction:
            t = count.to(torch.float32)
            rc1 = 1.0 / (1.0 - torch.pow(self.beta1, t))
            rc2 = 1.0 / (1.0 - torch.pow(self.beta2, t))
        else:
            rc1 = rc2 = torch.ones((), dtype=torch.float32, device=dev)
        return (fl, g_shard, new_residual, ok, inv_scale, gnorm, clip,
                count, lr_v, rc1, rc2)

    def _const(self, dev, *values):
        """Fixed hyperparameters as one fp32 tensor on ``dev``, copied
        there once (a copy each step would wait on the device)."""
        key = (torch.device(dev), values)
        if key not in self._consts:
            self._consts[key] = torch.tensor(values, dtype=torch.float32,
                                             device=dev)
        return self._consts[key]

    def _finish(self, ok, new_state, state, gnorm, fl, residual,
                new_residual):
        new_state = self._select(ok, new_state, state._replace(gnorm=gnorm))
        params = fl.unflatten(self._allgather(new_state.p))
        if residual is None:
            return params, new_state
        # a skipped step's quantization error was never applied
        return params, new_state, torch.where(ok > 0, new_residual,
                                              residual)

    # -- state bring-up ------------------------------------------------------

    def init(self, params):
        """This rank's sharded state (the master shard sliced from the
        flat params, zero moments)."""
        n = group_size(self.shard_group)
        fl = self._flattener(params, n)
        plan = self._shard_plan(fl, n)
        flat = fl.flatten(params)
        p_shard = flat[plan.lo:plan.lo + plan.per].clone()
        dev = p_shard.device
        return self._state_cls(
            torch.zeros((), dtype=torch.int32, device=dev), p_shard,
            torch.zeros(p_shard.shape, dtype=self.state_dtype, device=dev),
            torch.zeros(p_shard.shape, dtype=self.state_dtype, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev))


class DistributedFusedAdam(_DistributedFusedBase):
    """Sharded data-parallel Adam(W): FusedAdam's math on each rank's
    shard."""

    _state_cls = ShardedAdamState

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, weight_decay=0.0, amsgrad=False, adam_w_mode=True,
                 max_grad_norm=0.0, **kw):
        super().__init__(lr, weight_decay, **kw)
        if amsgrad:
            raise RuntimeError("DistributedFusedAdam does not support the "
                               "AMSGrad variant.")
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm

    def step(self, state: ShardedAdamState, grads, params, *, scale=1.0,
             lr=None, residual=None):
        """One collective step.  ``grads``: this rank's local, unreduced
        gradients (the full model); returns ``(new_params, new_state)``,
        or ``(new_params, new_state, new_residual)`` when ``residual``
        threads the int8 error-feedback state (:meth:`init_residual`)."""
        (fl, g_shard, new_residual, ok, inv_scale, gnorm, clip, count, lr_v,
         rc1, rc2) = self._begin(state, grads, params, scale, lr, residual)
        b1, b2 = self.beta1, self.beta2
        eff_scale = inv_scale * clip
        wd = self.weight_decay
        m32 = state.m.to(torch.float32)
        v32 = state.v.to(torch.float32)
        if self.impl == "fused":
            c = self._const(g_shard.device, b1, b2, self.eps, wd)
            scalars = torch.cat([lr_v[None], c, rc1[None], rc2[None],
                                 eff_scale[None]]).reshape(1, 8)
            p_new, m_new, v_new = kernels.fused_adam_flat(
                g_shard, state.p, m32, v32, scalars,
                adam_w_mode=self.adam_w_mode)
        else:
            g = g_shard * eff_scale
            p = state.p
            if not self.adam_w_mode:
                g = g + wd * p
            m_new = b1 * m32 + (1.0 - b1) * g
            v_new = b2 * v32 + (1.0 - b2) * g * g
            u = (m_new * rc1) / (torch.sqrt(v_new * rc2) + self.eps)
            if self.adam_w_mode:
                u = u + wd * p
            p_new = p - lr_v * u
        new_state = ShardedAdamState(count, p_new, self._store_moment(m_new),
                                     self._store_moment(v_new), gnorm)
        return self._finish(ok, new_state, state, gnorm, fl, residual,
                            new_residual)


class DistributedFusedLAMB(_DistributedFusedBase):
    """Sharded data-parallel LAMB: stage 1 on the shard, the per-tensor
    trust ratios (whose norms span shards) from per-shard segment sums and
    an all-reduce."""

    _state_cls = ShardedLAMBState

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, amsgrad=False, adam_w_mode=True,
                 grad_averaging=True, max_grad_norm=1.0, use_nvlamb=False,
                 **kw):
        super().__init__(lr, weight_decay, **kw)
        if amsgrad:
            raise RuntimeError("DistributedFusedLAMB does not support "
                               "AMSGrad.")
        self.bias_correction = bias_correction
        self.beta1, self.beta2 = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.grad_averaging = grad_averaging
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb

    def _seg_sumsq(self, fl: TreeFlattener, x, plan: _ShardPlan):
        """Per-leaf sums of squares across the shards: each leaf's rows
        clipped to this shard, summed in leaf order, then all-reduced over
        ``shard_group``."""
        part = fl.per_tensor_sumsq(x, rows=plan.rows)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.shard_group)
        return part

    def step(self, state: ShardedLAMBState, grads, params, *, scale=1.0,
             lr=None, residual=None):
        """One collective step; as :meth:`DistributedFusedAdam.step`."""
        (fl, g_shard, new_residual, ok, inv_scale, gnorm, clip, count, lr_v,
         rc1, rc2) = self._begin(state, grads, params, scale, lr, residual)
        plan = self._shard_plan(fl, group_size(self.shard_group))
        b1, b2 = self.beta1, self.beta2
        beta3 = 1.0 - b1 if self.grad_averaging else 1.0
        wd = self.weight_decay
        m32 = state.m.to(torch.float32)
        v32 = state.v.to(torch.float32)
        if self.impl == "fused":
            c = self._const(g_shard.device, b1, b2, self.eps, wd)
            scalars = torch.cat([c, rc1[None], rc2[None], clip[None],
                                 inv_scale[None],
                                 self._const(g_shard.device, beta3)]
                                ).reshape(1, 9)
            u, m_new, v_new = kernels.fused_lamb_stage1_flat(
                g_shard, state.p, m32, v32, scalars,
                adam_w_mode=self.adam_w_mode)
        else:
            g = g_shard * inv_scale * clip
            p = state.p
            if not self.adam_w_mode:
                g = g + wd * p
            m_new = b1 * m32 + beta3 * g
            v_new = b2 * v32 + (1.0 - b2) * g * g
            u = (m_new * rc1) / (torch.sqrt(v_new * rc2) + self.eps)
            if self.adam_w_mode:
                u = u + wd * state.p

        # stage 2: per-tensor trust ratios across shards
        w_norm = torch.sqrt(self._seg_sumsq(fl, state.p, plan))
        u_norm = torch.sqrt(self._seg_sumsq(fl, u, plan))
        ratio = torch.where((w_norm > 0) & (u_norm > 0), w_norm / u_norm,
                            torch.ones_like(w_norm))
        if not self.use_nvlamb and self.weight_decay == 0.0:
            ratio = torch.ones_like(ratio)
        ratio_rows = fl.broadcast_rows(ratio, rows=plan.rows)
        u_rows = u.reshape(-1, LANE)
        p_new = (state.p.reshape(u_rows.shape)
                 - lr_v * ratio_rows[:, None] * u_rows).reshape(
                     state.p.shape)
        new_state = ShardedLAMBState(count, p_new, self._store_moment(m_new),
                                     self._store_moment(v_new), gnorm)
        return self._finish(ok, new_state, state, gnorm, fl, residual,
                            new_residual)


def state_from_jax(state_np, rank: int, world: int, device=None):
    """A JAX package sharded state, its fields as global arrays (``p``,
    ``m``, ``v`` of the whole flat length, as ``shard_map`` returns them;
    numpy or anything ``np.asarray`` takes) -> rank ``rank``'s port state
    of ``world`` shards, on ``device`` (default ``"cuda"``).  A
    ``ShardedLAMBState`` comes back as one; anything else as a
    ``ShardedAdamState``."""
    dev = resolve_device(device)
    cls = ShardedLAMBState if type(state_np).__name__ == "ShardedLAMBState" \
        else ShardedAdamState

    def shard(a):
        a = np.asarray(a)
        dtype = torch.bfloat16 if a.dtype.name == "bfloat16" \
            else torch.float32
        per = a.shape[0] // world
        piece = np.array(a[rank * per:(rank + 1) * per], dtype=np.float32)
        return torch.from_numpy(piece).to(dev, dtype)

    return cls(
        torch.tensor(int(np.asarray(state_np.count)), dtype=torch.int32,
                     device=dev),
        shard(state_np.p), shard(state_np.m), shard(state_np.v),
        torch.tensor(float(np.asarray(state_np.gnorm)), dtype=torch.float32,
                     device=dev))
