"""Data-parallel gradient reduction over a process group.

Counterpart of ``apex_tpu/parallel/distributed.py``
(``DistributedDataParallel``, ``Reducer``, ``allreduce_tree``).  The JAX
package reduces with ``psum`` inside the jitted step; here one process runs
per card and the gradients are summed by ``torch.distributed`` over the
group.  Kept:

- ``gradient_average``: divide the sum by the world size;
- ``gradient_predivide_factor`` f: divide by f before the reduce and by
  world / f after (with ``gradient_average=False`` the result stays sum / f);
- ``allreduce_always_fp32``: fp16 and bf16 gradients go up to fp32 for the
  reduce (the scaling included) and back down after;
- ``broadcast_params``: every rank takes rank 0's parameters;
- the collective schemes of :mod:`~apex_tpu_torch.parallel.collectives`
  (``collective_scheme=`` a name, a spec string, a spec or a callable
  ``(path, leaf)``; ``collective_min_bytes``; int8 error-feedback
  ``residuals``; Adasum's own magnitude, where only the predivide is
  undone), metered through ``telemetry.events.record_collective``;
- ``overlap`` (:mod:`~apex_tpu_torch.parallel.overlap`): ``"bucketed"``
  reduces ``message_size``-element buckets, during the backward when the
  step takes its gradients through :meth:`DistributedDataParallel.grad`
  (gradient hooks); ``delay_allreduce=True`` pins ``"off"`` (one pass after
  the backward).  ``message_size`` takes effect only under ``"bucketed"``:
  ``"off"`` reduces the whole tree at once, as the JAX package's deferred
  path does;
- ``update_sharding="zero1"`` (:mod:`~apex_tpu_torch.parallel.
  weight_update`): :meth:`DistributedDataParallel.weight_update` hands back
  the sharded update engine;
- the knobs that have no meaning here warn (``allreduce_trigger_params``,
  ``retain_allreduce_buffers``, ``num_allreduce_streams``,
  ``allreduce_communicators``), as the JAX package's do, and so does
  ``prof``, which the JAX package stores unread;
- :class:`Reducer`, the reduction the caller triggers.

Without a scheme, the leaves of one dtype go into one flat buffer and one
all-reduce (the JAX package's per-leaf ``psum``s, coalesced; a sum is
elementwise, so the bits are the same).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from . import collectives as _coll
from . import overlap as _ov
from .mesh import check_group_device, group_size, resolve_group
from ..telemetry import events as _tel_events
from ..utils.device import resolve_device
from ..utils.pytree import (tree_flatten, tree_flatten_with_keystr,
                            tree_leaves, tree_unflatten)

__all__ = ["allreduce_tree", "DistributedDataParallel", "Reducer"]

DEFAULT_MESSAGE_SIZE = _ov.DEFAULT_MESSAGE_SIZE


def _plain_reduce(leaves, ids, group, pre, post, always_fp32, out, meter):
    """Sum ``leaves[ids]`` over ``group`` in one flat buffer per dtype,
    scaled by ``pre`` before and ``post`` after, into ``out``."""
    by_dtype: dict = {}
    for i in ids:
        g = leaves[i]
        if always_fp32 and g.dtype != torch.float32:
            g = g.float()
        by_dtype.setdefault(g.dtype, []).append((i, g))
    for dt, items in by_dtype.items():
        buf = torch.cat([g.reshape(-1) for _, g in items])
        check_group_device(buf, group)
        if pre != 1.0:
            buf.mul_(pre)
        if meter is not None:
            nbytes = buf.numel() * buf.element_size()
            meter["bytes"] += nbytes
            meter["wire"] += nbytes
            meter["leaves"] += len(items)
            meter["dtypes"].add(_coll.dtype_name(dt))
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        if post != 1.0:
            buf.mul_(post)
        off = 0
        for i, g in items:
            out[i] = buf[off:off + g.numel()].view(g.shape).to(
                leaves[i].dtype)
            off += g.numel()


def allreduce_tree(grads, *, axis_name=None, average: bool = True,
                   predivide_factor: Optional[float] = None,
                   always_fp32: bool = False, scheme=None, residuals=None,
                   min_compress_bytes: Optional[int] = None):
    """Sum a gradient tree over the process group ``axis_name`` with the
    reference's dtype and scaling semantics (``allreduce_bucket``).

    ``scheme`` picks a compressed or adaptive reduction per leaf: a scheme
    name, a spec string, a :class:`~apex_tpu_torch.parallel.collectives.
    CollectiveSpec` or a callable ``(path, leaf) -> scheme | None``;
    ``None`` takes the live override, then ``APEX_TPU_COLLECTIVES``, then
    the tuning profile's ``ddp_collective_scheme`` (on the card only), else
    the plain reduction.  Leaves under ``min_compress_bytes`` (default the
    spec's ``min_bytes``) stay fp32.  ``residuals`` (the int8
    error-feedback tree, :func:`~apex_tpu_torch.parallel.collectives.
    init_residuals`) makes it return ``(reduced, new_residuals)``.  With no
    group (``None`` and torch.distributed not initialised) it is the
    identity, as the JAX package's is outside a mapped context."""
    group = resolve_group(axis_name)
    if group is None:
        return grads if residuals is None else (grads, residuals)
    world = group_size(group)
    meter = ({"bytes": 0, "wire": 0, "leaves": 0, "dtypes": set()}
             if _tel_events.metering() else None)
    t0 = time.perf_counter()
    pre, post = _ov._scales(world, average, predivide_factor)

    per_leaf = callable(scheme)
    if per_leaf:
        leaves, paths, treedef = tree_flatten_with_keystr(grads)
        specs = [_coll.resolve(s, min_bytes=min_compress_bytes)
                 if (s := scheme(p, l)) is not None else None
                 for p, l in zip(paths, leaves)]
    else:
        leaves, treedef = tree_flatten(grads)
        specs = [_coll.resolve(scheme, min_bytes=min_compress_bytes)
                 ] * len(leaves)
    res_leaves = (tree_leaves(residuals) if residuals is not None
                  else [None] * len(leaves))
    out: List[Any] = [None] * len(leaves)
    out_res = list(res_leaves)

    plain = [i for i, s in enumerate(specs) if s is None]
    if plain:
        _plain_reduce(leaves, plain, group, pre, post, always_fp32, out,
                      meter)
    for i, spec in enumerate(specs):
        if spec is None:
            continue
        g = leaves[i]
        info = _coll.get_scheme(_coll.leaf_scheme(spec, g.numel() * 4))
        eff = dataclasses.replace(spec, scheme=info.name)
        x = g.to(torch.float32)
        if pre != 1.0:
            x = x * pre
        if meter is not None:
            meter["bytes"] += x.numel() * 4
            meter["wire"] += info.wire_bytes(x.numel(), eff.block)
            meter["leaves"] += 1
            meter["dtypes"].add(info.wire_dtype)
        x, new_r = _coll.reduce(eff, x, group, residual=res_leaves[i])
        # adasum sets its own magnitude: only the predivide is undone
        p = (predivide_factor or 1.0) if info.self_scaling else post
        if p != 1.0:
            x = x * p
        out[i] = x.to(g.dtype)
        if new_r is not None:
            out_res[i] = new_r

    if meter is not None:
        dts = meter["dtypes"]
        _tel_events.record_collective(
            _coll.axis_label(group), int(meter["bytes"]), meter["leaves"],
            time.perf_counter() - t0, wire_bytes=int(meter["wire"]),
            dtype=(next(iter(dts)) if len(dts) == 1 else
                   "mixed" if dts else None),
            scheme=(specs[0].scheme if specs and specs[0] is not None
                    and not per_leaf else ("per_leaf" if per_leaf
                                           else None)))
    reduced = tree_unflatten(treedef, out)
    if residuals is None:
        return reduced
    return reduced, tree_unflatten(tree_flatten(residuals)[1], out_res)


_NO_STREAM = ("overlap='bucketed' requested with a collective scheme that "
              "cannot stream per-bucket (adasum's pairwise tree needs the "
              "full grad set; callable routing is per-leaf) — falling back "
              "to the deferred allreduce")


class DistributedDataParallel:
    """Data-parallel gradient reduction for a functional training step::

        ddp = DistributedDataParallel(axis_name=group)   # None: default
        params = ddp.broadcast_params(params)            # rank 0's
        grads = ddp.grad(loss, leaves)                   # reduced

    :meth:`grad` is ``torch.autograd.grad(loss, leaves)`` followed by the
    reduction; under ``overlap="bucketed"`` (or ``APEX_TPU_OVERLAP=
    bucketed``) each bucket's all-reduce starts during the backward, from
    gradient hooks.  :meth:`allreduce_grads` reduces a gradient tree that
    already exists.

    ``module`` is optional: when given, ``ddp(*args)`` calls it unchanged.
    ``device`` (default ``"cuda"``, raising without CUDA) is where the
    gradients live; the reduction refuses gradients elsewhere, so a CPU
    run is always asked for."""

    def __init__(self, module: Optional[Callable] = None, *,
                 axis_name=None,
                 message_size: int = DEFAULT_MESSAGE_SIZE,
                 delay_allreduce: bool = False,
                 shared_param: Optional[bool] = None,
                 allreduce_trigger_params: Optional[Any] = None,
                 retain_allreduce_buffers: bool = False,
                 allreduce_always_fp32: bool = False,
                 num_allreduce_streams: int = 1,
                 allreduce_communicators: Optional[Any] = None,
                 gradient_average: bool = True,
                 gradient_predivide_factor: Optional[float] = None,
                 collective_scheme=None,
                 collective_min_bytes: Optional[int] = None,
                 update_sharding: Optional[str] = None,
                 allgather_scheme=None,
                 overlap: Optional[str] = None,
                 prof: bool = False,
                 device=None):
        if shared_param is not None:
            raise ValueError("shared_param is deprecated in the reference and "
                             "unsupported here")
        for name, val, default in (
                ("allreduce_trigger_params", allreduce_trigger_params, None),
                ("retain_allreduce_buffers", retain_allreduce_buffers, False),
                ("num_allreduce_streams", num_allreduce_streams, 1),
                ("allreduce_communicators", allreduce_communicators, None),
                ("prof", prof, False)):
            if val != default:
                warnings.warn(
                    f"DistributedDataParallel({name}=...) is a no-op: the "
                    "buckets' all-reduces go out in the layout's order on "
                    "the process group's own stream, and the profiler "
                    "(apex_tpu_torch.pyprof) times them")
        if overlap is not None:
            _ov.resolve_mode(overlap)
            if overlap == "bucketed" and delay_allreduce:
                _ov.warn_once(
                    ("delay_vs_overlap", str(axis_name)),
                    "DistributedDataParallel(delay_allreduce=True) pins the "
                    "deferred path; the explicit overlap='bucketed' request "
                    "is ignored")
        if update_sharding is not None:
            from . import weight_update as _wu
            _wu.resolve_mode(update_sharding)
        if not callable(collective_scheme):
            _coll.resolve(collective_scheme)     # an unknown name fails here
        self.module = module
        self.axis_name = axis_name
        self.message_size = int(message_size)
        if self.message_size <= 0:
            raise ValueError(f"message_size must be positive, got "
                             f"{message_size!r}")
        self.delay_allreduce = bool(delay_allreduce)
        self.overlap = overlap
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.collective_scheme = collective_scheme
        self.collective_min_bytes = collective_min_bytes
        self.update_sharding = update_sharding
        self.allgather_scheme = allgather_scheme
        self.device = resolve_device(device)
        #: the last hooked backward's engine (its ``launch_log`` and
        #: ``buckets``), None after a deferred one
        self.last_reduction: Optional[_ov.HookedReduction] = None

    def __call__(self, *args, **kwargs):
        if self.module is None:
            raise TypeError("DistributedDataParallel wraps no module; use "
                            "allreduce_grads on your gradient tree")
        return self.module(*args, **kwargs)

    def broadcast_params(self, params):
        """New copies of ``params`` holding rank 0's values (the group's
        first rank), the reference's broadcast at construction."""
        group = resolve_group(self.axis_name)
        if group is None:
            return params
        src = dist.get_global_rank(group, 0) \
            if group is not dist.group.WORLD else 0
        leaves, treedef = tree_flatten(params)
        out = []
        for p in leaves:
            t = p.detach().clone()
            check_group_device(t, group)
            dist.broadcast(t, src, group=group)
            out.append(t)
        return tree_unflatten(treedef, out)

    # -- gradient reduction --------------------------------------------------

    def mode(self) -> str:
        """The overlap mode a reduction takes now: ``"off"`` under
        ``delay_allreduce``, else the constructor's ``overlap`` >
        ``APEX_TPU_OVERLAP`` > the profile's ``ddp_overlap`` > ``"off"``; a scheme that cannot stream falls
        back to ``"off"`` with a one-time warning."""
        mode = "off" if self.delay_allreduce else _ov.resolve_mode(
            self.overlap)
        if mode == "bucketed" and not _ov.can_stream(self.collective_scheme):
            _ov.warn_once(("no_stream", str(self.collective_scheme)),
                          _NO_STREAM)
            mode = "off"
        return mode

    def _check(self, tree):
        for g in tree_leaves(tree):
            if g.device.type != self.device.type:
                raise RuntimeError(
                    f"a gradient on {g.device} reaches a "
                    f"DistributedDataParallel made for {self.device}")

    def _kwargs(self):
        return dict(axis_name=self.axis_name,
                    average=self.gradient_average,
                    predivide_factor=self.gradient_predivide_factor,
                    always_fp32=self.allreduce_always_fp32,
                    scheme=self.collective_scheme,
                    min_compress_bytes=self.collective_min_bytes)

    def allreduce_grads(self, grads, residuals=None):
        """Reduce a gradient tree over the group: the bucketed path
        (:func:`~apex_tpu_torch.parallel.overlap.bucketed_allreduce`, one
        collective per ``message_size`` bucket) when the mode resolves to
        ``"bucketed"``, else the deferred :func:`allreduce_tree`.
        ``residuals`` threads the int8 error-feedback state; it makes the
        return ``(grads, new_residuals)``."""
        self._check(grads)
        if self.mode() == "bucketed":
            return _ov.bucketed_allreduce(grads, residuals=residuals,
                                          message_size=self.message_size,
                                          **self._kwargs())
        return allreduce_tree(grads, residuals=residuals, **self._kwargs())

    def grad(self, loss: torch.Tensor, inputs, *, residuals=None,
             retain_graph: Optional[bool] = None):
        """``torch.autograd.grad(loss, inputs)`` reduced over the group:
        ``inputs`` is a tree of tensors that require grad (a list of the
        step's leaves, or the parameter tree itself); the reduced
        gradients come back in the same structure (an input the loss does
        not reach gets a reduced zero).

        In ``"bucketed"`` mode with a group, every input gets a gradient
        hook (:class:`~apex_tpu_torch.parallel.overlap.HookedReduction`)
        and each bucket's all-reduce is launched while the backward still
        runs, in the layout's order; the result is the bits of
        :meth:`allreduce_grads` on the same gradients.  Otherwise the
        backward runs first and :meth:`allreduce_grads` follows.
        ``residuals`` makes the return ``(grads, new_residuals)``."""
        leaves, paths, treedef = tree_flatten_with_keystr(inputs)
        self._check(inputs)
        group = resolve_group(self.axis_name)
        self.last_reduction = None
        if group is None or self.mode() != "bucketed":
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        retain_graph=retain_graph)
            grads = [torch.zeros_like(l) if g is None else g
                     for g, l in zip(grads, leaves)]
            return self.allreduce_grads(tree_unflatten(treedef, grads),
                                        residuals)
        kw = self._kwargs()
        del kw["axis_name"], kw["scheme"], kw["min_compress_bytes"]
        spec = _coll.resolve(self.collective_scheme,
                             min_bytes=self.collective_min_bytes)
        eng = _ov.HookedReduction(
            leaves, paths, group, spec=spec,
            residuals=(tree_leaves(residuals) if residuals is not None
                       else None),
            message_size=self.message_size, **kw)
        handles = [leaf.register_hook(eng.hook(i))
                   for i, leaf in enumerate(leaves)]
        try:
            torch.autograd.grad(loss, leaves, allow_unused=True,
                                retain_graph=retain_graph)
        finally:
            for h in handles:
                h.remove()
        out, out_res = eng.finish()
        self.last_reduction = eng
        reduced = tree_unflatten(treedef, out)
        if residuals is None:
            return reduced
        return reduced, tree_unflatten(tree_flatten(residuals)[1], out_res)

    def init_residuals(self, grads):
        """Zero error-feedback residuals to carry in step state when
        ``collective_scheme="int8_blockscale"``."""
        return _coll.init_residuals(grads)

    # -- weight-update sharding ----------------------------------------------

    def weight_update(self, optimizer, **kwargs):
        """The zero1 path: a :class:`~apex_tpu_torch.parallel.weight_update.
        ShardedUpdate` with this DDP's group, averaging and collective
        settings, or None when the mode resolves to ``"off"`` (constructor
        ``update_sharding`` > ``APEX_TPU_UPDATE_SHARDING`` > the profile's
        ``ddp_update_sharding`` > off); the
        caller then keeps :meth:`allreduce_grads` and a replicated
        update."""
        from . import weight_update as _wu
        if _wu.resolve_mode(self.update_sharding) == "off":
            return None
        kwargs.setdefault("collective_scheme", self.collective_scheme)
        kwargs.setdefault("collective_min_bytes", self.collective_min_bytes)
        kwargs.setdefault("allgather_scheme", self.allgather_scheme)
        kwargs.setdefault("gradient_predivide_factor",
                          self.gradient_predivide_factor)
        kwargs.setdefault("overlap",
                          "off" if self.delay_allreduce else self.overlap)
        kwargs.setdefault("message_size", self.message_size)
        return _wu.ShardedUpdate(optimizer, axis_name=self.axis_name,
                                 gradient_average=self.gradient_average,
                                 **kwargs)

    def wrap_grad_fn(self, grad_fn: Callable) -> Callable:
        """``grad_fn`` with the reduction after it (a ``(aux, grads)``
        pair reduces its second element)."""
        def wrapped(*args, **kwargs):
            out = grad_fn(*args, **kwargs)
            if isinstance(out, tuple) and len(out) == 2:
                aux, grads = out
                return aux, self.allreduce_grads(grads)
            return self.allreduce_grads(out)
        return wrapped


class Reducer:
    """The reduction the caller triggers (``apex.parallel.Reducer``): no
    hooks; ``reduce(grads)`` is :func:`allreduce_tree` (or the bucketed
    path under ``overlap="bucketed"``) over its group."""

    def __init__(self, module_or_grads_fn=None, *, axis_name=None,
                 gradient_average: bool = True, collective_scheme=None,
                 collective_min_bytes: Optional[int] = None,
                 update_sharding: Optional[str] = None,
                 overlap: Optional[str] = None,
                 message_size: int = DEFAULT_MESSAGE_SIZE):
        self.module = module_or_grads_fn
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.collective_scheme = collective_scheme
        self.collective_min_bytes = collective_min_bytes
        if update_sharding is not None:
            from . import weight_update as _wu
            _wu.resolve_mode(update_sharding)
        self.update_sharding = update_sharding
        if overlap is not None:
            _ov.resolve_mode(overlap)
        self.overlap = overlap
        self.message_size = int(message_size)

    def reduce(self, grads, residuals=None):
        mode = _ov.resolve_mode(self.overlap)
        if mode == "bucketed" and not _ov.can_stream(self.collective_scheme):
            _ov.warn_once(("no_stream", str(self.collective_scheme)),
                          _NO_STREAM)
            mode = "off"
        kw = dict(axis_name=self.axis_name, average=self.gradient_average,
                  scheme=self.collective_scheme, residuals=residuals,
                  min_compress_bytes=self.collective_min_bytes)
        if mode == "bucketed":
            return _ov.bucketed_allreduce(grads,
                                          message_size=self.message_size,
                                          **kw)
        return allreduce_tree(grads, **kw)

    def weight_update(self, optimizer, **kwargs):
        """The zero1 factory of :meth:`DistributedDataParallel.
        weight_update` (None when the mode is ``"off"``)."""
        from . import weight_update as _wu
        if _wu.resolve_mode(self.update_sharding) == "off":
            return None
        kwargs.setdefault("collective_scheme", self.collective_scheme)
        kwargs.setdefault("collective_min_bytes", self.collective_min_bytes)
        kwargs.setdefault("overlap", self.overlap)
        kwargs.setdefault("message_size", self.message_size)
        return _wu.ShardedUpdate(optimizer, axis_name=self.axis_name,
                                 gradient_average=self.gradient_average,
                                 **kwargs)
