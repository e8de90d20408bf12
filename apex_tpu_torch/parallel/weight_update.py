"""Weight-update sharding for plain DDP (zero1).

Counterpart of ``apex_tpu/parallel/weight_update.py`` (arXiv:2004.13336).
The all-reduce and the update every replica repeats become:

  1. a **reduce-scatter** of the flat gradient buffer: each rank receives
     its contiguous 1/N slice of the sum (the compressed schemes of
     :mod:`~apex_tpu_torch.parallel.collectives` ride it, with an optional
     int8 error-feedback residual);
  2. the optimizer's **``step_flat_shard``** over that slice of the flat
     master and moment buffers (elementwise optimizers run ``step_flat``
     unchanged; LAMB and NovoGrad take their per-tensor norms across
     shards from :class:`ShardContext`);
  3. an **all-gather of the updated params** (fp32, or ``bf16`` /
     ``int8_blockscale`` when ``allgather_scheme`` asks; the ambient
     ``APEX_TPU_COLLECTIVES`` never quantizes params).

The optimizer state and the update's work per rank drop to 1/N while the
step keeps DDP's shape: replicated params in, local gradients in,
replicated params out.  One process per card: the JAX package's mesh axis
is a ``torch.distributed`` process group here, and its ``axis_index`` the
rank in that group.

amp: ``step(..., scale=)`` divides the gradients inside the update, and the
overflow flag is taken over the full local flat gradients before the
scatter and all-reduced with MIN, so every rank skips together even when a
compressed scatter would mangle the non-finite values; a skipped step keeps
the old state and the old residual.

Mode (:func:`resolve_mode`): explicit ``update_sharding`` >
``APEX_TPU_UPDATE_SHARDING`` > the tuning profile's ``ddp_update_sharding``
(:data:`TUNING_KEY`, on the card only) > ``"off"``.  The param
all-gather's scheme: explicit ``allgather_scheme`` > the profile's
``ddp_update_allgather_scheme`` (:data:`AG_TUNING_KEY`) > fp32; the ambient
``APEX_TPU_COLLECTIVES`` is not read for it.  Under ``overlap="bucketed"`` the scatter runs
in column chunks and the gather in segments
(:func:`~apex_tpu_torch.parallel.overlap.chunked_reduce_scatter`,
:func:`~apex_tpu_torch.parallel.overlap.segmented_allgather`), bitwise
equal for fp32.

Telemetry: ``ddp.reduce_scatter`` / ``ddp.param_allgather`` through
``record_collective`` (logical and wire bytes, scheme, dtype), and the
``ddp.opt_state_bytes_per_replica`` / ``ddp.update_shard_world`` gauges.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from . import collectives as _coll
from . import overlap as _ov
from .mesh import group_rank, group_size, resolve_group
from ..multi_tensor_apply.flattener import LANE, TreeFlattener
from ..telemetry import events as _tel_events
from ..utils import tuning
from ..utils.pytree import tree_leaves, tree_map

__all__ = ["MODES", "ENV_KNOB", "TUNING_KEY", "AG_TUNING_KEY",
           "resolve_mode", "ShardContext", "ShardedUpdate"]

MODES = ("off", "zero1")
ENV_KNOB = "APEX_TPU_UPDATE_SHARDING"
TUNING_KEY = "ddp_update_sharding"
AG_TUNING_KEY = "ddp_update_allgather_scheme"


def resolve_mode(mode: Optional[str] = None) -> str:
    """Explicit ``mode`` > ``APEX_TPU_UPDATE_SHARDING`` > the tuning
    profile's ``ddp_update_sharding`` (on the card only) > ``"off"``."""
    if mode is None:
        env = os.environ.get(ENV_KNOB)
        if env is not None and env.strip():
            mode = env.strip().lower()
        else:
            mode = tuning.get_on_gpu(TUNING_KEY, "off")
    if mode not in MODES:
        raise ValueError(
            f"update_sharding must be one of {MODES}, got {mode!r}")
    return mode


class ShardContext:
    """What ``FusedOptimizer.step_flat_shard`` needs of one sharded update:
    the group, the packing plan (``chunk = LANE * n_shards``: whole-row
    shards), this rank's rows, and the per-tensor reductions across shards
    (each an all-reduce of this rank's partials)."""

    def __init__(self, group, flattener: TreeFlattener, n_shards: int,
                 rank: Optional[int] = None):
        self.group = group
        self.flattener = flattener
        self.n_shards = int(n_shards)
        self.rank = group_rank(group) if rank is None else int(rank)

    @property
    def shard_rows(self) -> int:
        return self.flattener.total // LANE // self.n_shards

    @property
    def rows(self) -> Tuple[int, int]:
        """This shard's rows of the flat buffer, ``(lo, hi)``."""
        lo = self.rank * self.shard_rows
        return lo, lo + self.shard_rows

    def _sum(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def global_sumsq(self, x_shard: torch.Tensor) -> torch.Tensor:
        """Sum of squares over every shard."""
        return self._sum((x_shard.float() ** 2).sum())

    def per_tensor_sumsq(self, x_shard: torch.Tensor) -> torch.Tensor:
        """(num_leaves,) sums of squares across shards: each leaf's rows
        clipped to this shard, summed in leaf order, then all-reduced."""
        return self._sum(self.flattener.per_tensor_sumsq(x_shard,
                                                         rows=self.rows))

    def per_tensor_maxabs(self, x_shard: torch.Tensor) -> torch.Tensor:
        """(num_leaves,) max |x| across shards; a leaf with no row in this
        shard gives 0 here (never above a true max-abs), a NaN or inf
        partial propagates."""
        fl = self.flattener
        if not fl.leaf_row_ranges:
            return torch.zeros(0, dtype=torch.float32,
                               device=x_shard.device)
        row_max = x_shard.view(-1, LANE).float().abs().amax(dim=1)
        zero = torch.zeros((), dtype=torch.float32, device=x_shard.device)
        part = torch.stack([row_max[r0:r1].amax() if r1 > r0 else zero
                            for r0, r1 in fl._ranges(self.rows)])
        return self._sum(part, dist.ReduceOp.MAX)

    def broadcast_rows(self, values: torch.Tensor) -> torch.Tensor:
        """(num_leaves,) per-tensor values -> (shard_rows,) per-row values
        of this shard (0 on padding rows)."""
        return self.flattener.broadcast_rows(values, rows=self.rows)


class ShardedUpdate:
    """The zero1 engine: wraps a fused-flat optimizer (``impl="fused"``);
    ``init`` and ``step`` are collectives over ``axis_name`` (a process
    group; None: the default group)::

        ddp = DistributedDataParallel(update_sharding="zero1")
        opt = FusedAdam(lr=1e-3, impl="fused")
        wu = ddp.weight_update(opt)
        state = wu.init(params)                     # 1/N state per rank
        params, state = wu.step(state, local_grads, params)

    ``collective_scheme`` / ``collective_min_bytes`` ride the gradient
    reduce-scatter (default: the live override, then
    ``APEX_TPU_COLLECTIVES``, then the profile's ``ddp_collective_scheme``);
    ``allgather_scheme`` the param gather (default: the profile's
    ``ddp_update_allgather_scheme``, then fp32).  ``residual`` threads the int8
    error-feedback state (:meth:`init_residual`)."""

    def __init__(self, optimizer, *, axis_name=None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: Optional[float] = None,
                 check_overflow: bool = True,
                 collective_scheme=None,
                 collective_min_bytes: Optional[int] = None,
                 allgather_scheme=None,
                 overlap: Optional[str] = None,
                 message_size: Optional[int] = None):
        if getattr(optimizer, "impl", None) != "fused":
            raise ValueError(
                "weight-update sharding needs the flat engine: construct "
                "the optimizer with impl='fused' (the flat master and "
                "moment buffers are what make the 1/N slice trivial)")
        self.optimizer = optimizer
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.check_overflow = check_overflow
        self.collective_scheme = collective_scheme
        self.collective_min_bytes = collective_min_bytes
        self.allgather_scheme = allgather_scheme
        if overlap is not None:
            _ov.resolve_mode(overlap)
        self.overlap = overlap
        self.message_size = message_size

    @property
    def group(self):
        group = resolve_group(self.axis_name)
        if group is None:
            raise RuntimeError(
                "weight-update sharding is a collective: initialise "
                "torch.distributed or pass axis_name=<process group>")
        return group

    # -- packing -------------------------------------------------------------

    def _fl(self, params, n_shards: int) -> TreeFlattener:
        return self.optimizer.flattener_for(params, chunk=LANE * n_shards)

    def layout_meta(self, params, n_shards: int) -> dict:
        """The flat-shard layout a checkpoint manifest records for an
        elastic re-slice: the chunk pin, the padded total, the ``used``
        prefix holding leaf data, each shard's offset."""
        fl = self._fl(params, n_shards)
        per = fl.total // n_shards
        return {
            "kind": "zero1_flat",
            "lane": LANE,
            "chunk": fl.chunk,
            "flat_total": fl.total,
            "used": int(fl.offsets[-1]),
            "shard_offsets": [i * per for i in range(n_shards)],
        }

    # -- scheme resolution ---------------------------------------------------

    def _resolve_rs(self):
        """Gradient reduce-scatter scheme: explicit > live override >
        ``APEX_TPU_COLLECTIVES`` > the DDP tuning winner (the DDP gradient
        wire, scattered)."""
        return _coll.resolve(self.collective_scheme,
                             min_bytes=self.collective_min_bytes)

    def _resolve_ag(self):
        """Param all-gather scheme: explicit > the profile's
        ``ddp_update_allgather_scheme`` (on the card only) > fp32.  The
        ambient ``APEX_TPU_COLLECTIVES`` is not read: quantizing params is
        an accuracy trade the ambient knob must not flip."""
        if self.allgather_scheme is not None:
            return _coll.resolve(self.allgather_scheme, tuning_key=None)
        name = tuning.get_on_gpu(AG_TUNING_KEY)
        if name and name != "fp32":
            return _coll.resolve(name, tuning_key=None)
        return None

    # -- metering ------------------------------------------------------------

    def _meter(self, op, logical, wire, seconds, scheme, dtype):
        if _tel_events.metering():
            _tel_events.record_collective(
                _coll.axis_label(self.group), int(logical), 1, seconds,
                wire_bytes=int(wire), dtype=dtype, scheme=scheme, op=op,
                family="ddp")

    @staticmethod
    def _state_bytes(state) -> int:
        return int(sum(l.numel() * l.element_size()
                       for l in tree_leaves(state)
                       if isinstance(l, torch.Tensor)))

    def _gauge_state(self, state, n_shards: int):
        _tel_events.record_update_sharding(self._state_bytes(state),
                                           n_shards)

    # -- state ---------------------------------------------------------------

    def init(self, params):
        """This rank's sharded state: the optimizer's full flat state with
        every flat-length field cut to this rank's slice (scalars and
        per-tensor vectors, NovoGrad's ``v``, stay whole)."""
        group = self.group
        n = group_size(group)
        fl = self._fl(params, n)
        state = self._slice_state(self.optimizer.init(params), fl, n,
                                  group_rank(group))
        self._gauge_state(state, n)
        return state

    @staticmethod
    def _slice_state(state, fl: TreeFlattener, n_shards: int, rank: int):
        per = fl.total // n_shards

        def slice_leaf(l):
            if isinstance(l, torch.Tensor) and l.dim() == 1 \
                    and l.shape[0] == fl.total:
                return l[rank * per:(rank + 1) * per].clone()
            return l
        return tree_map(slice_leaf, state)

    def state_pspecs(self, params, n_shards: int):
        """Which state fields are shard-length: the state's structure with
        ``"shard"`` on each flat-length field and ``"replicated"``
        elsewhere (torch has no ``PartitionSpec``; this is its
        description).  Shapes only: built from ``meta`` tensors."""
        fl = self._fl(params, n_shards)
        meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                              device="meta"), params)
        shape_state = self.optimizer.init(meta)
        return tree_map(
            lambda l: ("shard" if l.dim() == 1 and l.shape[0] == fl.total
                       else "replicated"), shape_state)

    def init_residual(self, params):
        """Zero int8 error-feedback residual of the gradient reduce-scatter:
        full flat, fp32, on the params' device."""
        n = group_size(self.group)
        dev = tree_leaves(params)[0].device
        return torch.zeros(self._fl(params, n).total, dtype=torch.float32,
                           device=dev)

    # -- the step ------------------------------------------------------------

    def step(self, state, grads, params, *, scale=1.0, lr=None,
             residual=None, finite_group=None):
        """One collective step: this rank's local unreduced gradients (the
        whole model) in; ``(new_params, new_state)`` out, or a 3-tuple
        ending in the new residual when ``residual`` is passed.  ``params``
        gives the structure and dtypes; ``scale`` divides the gradients.
        ``finite_group`` (default the update's group): the group the
        finite flag's MIN runs over, wider for ranks that hold different
        leaves (tensor-parallel shards)."""
        group = self.group
        mode = _ov.resolve_mode(self.overlap)
        msize = (self.message_size if self.message_size is not None
                 else _ov.DEFAULT_MESSAGE_SIZE)
        n = group_size(group)
        fl = self._fl(params, n)
        flat_g = fl.flatten(grads)

        # the finite flag over the full local gradients, before the
        # scatter, MIN over the group: every rank skips together
        if self.check_overflow:
            ok = torch.isfinite(flat_g).all().to(torch.float32)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN,
                            group=group if finite_group is None
                            else finite_group)
        else:
            ok = torch.ones((), dtype=torch.float32, device=flat_g.device)

        pre, post = _ov._scales(n, self.gradient_average,
                                self.gradient_predivide_factor)
        spec = self._resolve_rs()
        if spec is not None:
            name = _coll.leaf_scheme(spec, flat_g.numel() * 4)
            if name != spec.scheme:
                spec = dataclasses.replace(spec, scheme=name)
        info = _coll.get_scheme(spec.scheme) if spec is not None else None
        if pre != 1.0:
            flat_g = flat_g * pre
        stream = mode == "bucketed"
        if stream and info is not None and info.self_scaling:
            _ov.warn_once(
                ("no_stream_rs", spec.scheme),
                "overlap='bucketed' requested with a collective scheme "
                "that cannot stream per-chunk (adasum's pairwise merge "
                "needs the full grad buffer) — falling back to the "
                "whole-buffer reduce-scatter")
            stream = False
        sname = spec.scheme if spec is not None else None
        sdtype = info.wire_dtype if info is not None else "float32"
        if stream:
            g_shard, new_residual, _ = _ov.chunked_reduce_scatter(
                flat_g, group, spec, residual=residual, message_size=msize,
                label="ddp.reduce_scatter",
                on_chunk=lambda logical, wire, dt: self._meter(
                    "reduce_scatter", logical, wire, dt, sname, sdtype))
        else:
            t0 = time.perf_counter()
            g_shard, new_residual = _coll.reduce_scatter_flat(
                flat_g, group, spec, residual=residual,
                label="ddp.reduce_scatter")
            logical = flat_g.numel() * 4
            self._meter("reduce_scatter", logical,
                        (info.wire_bytes(flat_g.numel(), spec.block)
                         if info is not None else logical),
                        time.perf_counter() - t0, sname, sdtype)
        # adasum sets its own magnitude: only the predivide is undone
        p_scale = ((self.gradient_predivide_factor or 1.0)
                   if info is not None and info.self_scaling else post)
        if p_scale != 1.0:
            g_shard = g_shard * p_scale

        ctx = ShardContext(group, fl, n)
        new_state = self.optimizer.step_flat_shard(
            state, g_shard, shard=ctx, scale=scale, lr=lr)
        keep = ok > 0
        new_state = tree_map(lambda nw, old: torch.where(keep, nw, old),
                             new_state, state)
        if residual is not None:
            # a skipped step's quantization error was never applied
            new_residual = torch.where(keep, new_residual, residual)
        self._gauge_state(new_state, n)

        ag_spec = self._resolve_ag()
        agname = ag_spec.scheme if ag_spec is not None else None
        agdtype = {"int8_blockscale": "int8",
                   "bf16": "bfloat16"}.get(agname, "float32")
        if mode == "bucketed":
            full, _, _, _ = _ov.segmented_allgather(
                new_state.master, group, ag_spec, message_size=msize,
                label="ddp.param_allgather",
                on_segment=lambda logical, wire, dt: self._meter(
                    "param_allgather", logical, wire, dt, agname, agdtype))
        else:
            t0 = time.perf_counter()
            full, ag_wire, ag_dtype = _coll.allgather_flat(
                new_state.master, group, ag_spec,
                label="ddp.param_allgather")
            self._meter("param_allgather", new_state.master.numel() * 4,
                        ag_wire, time.perf_counter() - t0, agname, ag_dtype)

        new_params = fl.unflatten(full, like=params)
        if residual is None:
            return new_params, new_state
        return new_params, new_state, new_residual
