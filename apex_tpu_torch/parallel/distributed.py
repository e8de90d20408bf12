"""Data-parallel gradient reduction over a process group.

Counterpart of ``apex_tpu/parallel/distributed.py``
(``DistributedDataParallel``, ``Reducer``, ``allreduce_tree``).  The JAX
package reduces with ``psum`` inside the jitted step; here one process runs
per card and the gradients, taken by ``torch.autograd.grad``, are summed by
``torch.distributed.all_reduce`` over the group after the backward.  Kept:

- ``gradient_average``: divide the sum by the world size;
- ``gradient_predivide_factor`` f: divide by f before the reduce and by
  world / f after (with ``gradient_average=False`` the result stays sum / f);
- ``allreduce_always_fp32``: fp16 and bf16 gradients go up to fp32 for the
  reduce (the scaling included) and back down after;
- ``broadcast_params``: every rank takes rank 0's parameters;
- ``message_size`` buckets: the leaves in reverse flat order (about the
  order the backward produces them), a bucket closed once it holds
  ``message_size`` elements, each bucket one coalesced all-reduce per
  dtype; ``delay_allreduce=True`` reduces the whole tree in one pass.  An
  all-reduce is elementwise, so every bucketing gives the same values;
- the knobs that have no meaning here warn (``allreduce_trigger_params``,
  ``retain_allreduce_buffers``, ``num_allreduce_streams``,
  ``allreduce_communicators``), as the JAX package's do;
- :class:`Reducer`, the reduction the caller triggers.

Not ported yet (ROADMAP.md): the compressed and adaptive schemes (``bf16``,
``int8_blockscale``, ``adasum``), the error-feedback residuals and
weight-update sharding raise ``NotImplementedError``; the reduction does
not overlap the backward (no gradient hooks), so ``overlap="bucketed"``
raises too.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from . import collectives
from .mesh import check_group_device, group_size, resolve_group
from ..utils.device import resolve_device
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["allreduce_tree", "DistributedDataParallel", "Reducer",
           "bucket_order"]

DEFAULT_MESSAGE_SIZE = 10_000_000


def _check_scheme(scheme, residuals=None) -> None:
    """Only the plain reduction is ported: a compressed or adaptive scheme,
    a per-leaf routing callable or error-feedback residuals raise."""
    if callable(scheme):
        raise NotImplementedError(
            "per-leaf collective routing is not ported yet; see ROADMAP.md")
    spec = collectives.resolve(scheme)
    if spec is not None and spec.scheme != "fp32":
        raise NotImplementedError(
            f"the {spec.scheme!r} allreduce scheme is not ported yet (the "
            "port reduces in the gradients' dtype or fp32); see ROADMAP.md")
    if residuals is not None:
        raise NotImplementedError(
            "error-feedback residuals come with the int8 scheme, which is "
            "not ported yet; see ROADMAP.md")


def bucket_order(sizes, message_size: Optional[int]) -> List[List[int]]:
    """Leaf indices in buckets: reverse flat order, a bucket closed once it
    holds ``message_size`` elements (a large leaf overflows its bucket;
    the last may be smaller).  ``None``: one bucket of every leaf."""
    order = list(range(len(sizes) - 1, -1, -1))
    if message_size is None:
        return [order] if order else []
    buckets, cur, elems = [], [], 0
    for i in order:
        cur.append(i)
        elems += sizes[i]
        if elems >= message_size:
            buckets.append(cur)
            cur, elems = [], 0
    if cur:
        buckets.append(cur)
    return buckets


def _reduce(grads, group, *, average, predivide_factor, always_fp32,
            message_size):
    """Sum ``grads`` over ``group`` bucket by bucket, with the reference's
    scaling; a new tree of the input's dtypes."""
    world = group_size(group)
    pre = 1.0 / predivide_factor if predivide_factor is not None else 1.0
    if predivide_factor is not None:
        post = predivide_factor / world if average else 1.0
    else:
        post = 1.0 / world if average else 1.0
    leaves, treedef = tree_flatten(grads)
    out: List[Any] = [None] * len(leaves)
    for ids in bucket_order([g.numel() for g in leaves], message_size):
        by_dtype: dict = {}
        for i in ids:
            g = leaves[i]
            if always_fp32 and g.dtype != torch.float32:
                g = g.float()
            by_dtype.setdefault(g.dtype, []).append((i, g))
        for items in by_dtype.values():
            buf = torch.cat([g.reshape(-1) for _, g in items])
            check_group_device(buf, group)
            if pre != 1.0:
                buf.mul_(pre)
            dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
            if post != 1.0:
                buf.mul_(post)
            off = 0
            for i, g in items:
                out[i] = buf[off:off + g.numel()].view(g.shape).to(
                    leaves[i].dtype)
                off += g.numel()
    return tree_unflatten(treedef, out)


def allreduce_tree(grads, *, axis_name=None, average: bool = True,
                   predivide_factor: Optional[float] = None,
                   always_fp32: bool = False, scheme=None, residuals=None):
    """Sum a gradient tree over the process group ``axis_name`` with the
    reference's dtype and scaling semantics (``allreduce_bucket``), in one
    coalesced all-reduce per dtype.  With no group (``None`` and
    torch.distributed not initialised) it is the identity, as the JAX
    package's is outside a mapped context."""
    _check_scheme(scheme, residuals)
    group = resolve_group(axis_name)
    if group is None:
        return grads
    return _reduce(grads, group, average=average,
                   predivide_factor=predivide_factor,
                   always_fp32=always_fp32, message_size=None)


class DistributedDataParallel:
    """Data-parallel gradient reduction for a functional training step::

        ddp = DistributedDataParallel(axis_name=group)   # None: default
        params = ddp.broadcast_params(params)            # rank 0's
        grads = torch.autograd.grad(loss, leaves)
        grads = ddp.allreduce_grads(grads)

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
                 update_sharding: Optional[str] = None,
                 overlap: Optional[str] = None,
                 device=None):
        if shared_param is not None:
            raise ValueError("shared_param is deprecated in the reference and "
                             "unsupported here")
        for name, val, default in (
                ("allreduce_trigger_params", allreduce_trigger_params, None),
                ("retain_allreduce_buffers", retain_allreduce_buffers, False),
                ("num_allreduce_streams", num_allreduce_streams, 1),
                ("allreduce_communicators", allreduce_communicators, None)):
            if val != default:
                warnings.warn(
                    f"DistributedDataParallel({name}=...) is a no-op: the "
                    "gradients are reduced after the backward, in buckets, "
                    "on the default stream")
        if overlap not in (None, "off", "bucketed"):
            raise ValueError(f"overlap must be one of ('off', 'bucketed'), "
                             f"got {overlap!r}")
        if overlap == "bucketed":
            raise NotImplementedError(
                "overlap='bucketed' (reduction during the backward) is not "
                "ported yet; the port reduces after the backward")
        if update_sharding not in (None, "off", "zero1"):
            raise ValueError(f"update_sharding must be one of ('off', "
                             f"'zero1'), got {update_sharding!r}")
        if update_sharding == "zero1":
            raise NotImplementedError(
                "weight-update sharding (zero1) is not ported yet; see "
                "ROADMAP.md")
        _check_scheme(collective_scheme)
        self.module = module
        self.axis_name = axis_name
        self.message_size = int(message_size)
        if self.message_size <= 0:
            raise ValueError(f"message_size must be positive, got "
                             f"{message_size!r}")
        self.delay_allreduce = bool(delay_allreduce)
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.collective_scheme = collective_scheme
        self.device = resolve_device(device)

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

    def allreduce_grads(self, grads, residuals=None):
        """Reduce a gradient tree over the group: ``message_size`` buckets,
        or one pass with ``delay_allreduce``."""
        _check_scheme(self.collective_scheme, residuals)
        for g in tree_leaves(grads):
            if g.device.type != self.device.type:
                raise RuntimeError(
                    f"a gradient on {g.device} reaches a "
                    f"DistributedDataParallel made for {self.device}")
        group = resolve_group(self.axis_name)
        if group is None:
            return grads
        return _reduce(grads, group, average=self.gradient_average,
                       predivide_factor=self.gradient_predivide_factor,
                       always_fp32=self.allreduce_always_fp32,
                       message_size=(None if self.delay_allreduce
                                     else self.message_size))


class Reducer:
    """The reduction the caller triggers (``apex.parallel.Reducer``): no
    hooks; ``reduce(grads)`` is :func:`allreduce_tree` over its group."""

    def __init__(self, module_or_grads_fn=None, *, axis_name=None,
                 gradient_average: bool = True, collective_scheme=None,
                 update_sharding: Optional[str] = None,
                 overlap: Optional[str] = None):
        if update_sharding not in (None, "off"):
            raise NotImplementedError(
                "weight-update sharding is not ported yet; see ROADMAP.md")
        if overlap not in (None, "off"):
            raise NotImplementedError(
                "overlap='bucketed' is not ported yet; see ROADMAP.md")
        _check_scheme(collective_scheme)
        self.module = module_or_grads_fn
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.collective_scheme = collective_scheme

    def reduce(self, grads, residuals=None):
        return allreduce_tree(grads, axis_name=self.axis_name,
                              average=self.gradient_average,
                              scheme=self.collective_scheme,
                              residuals=residuals)
