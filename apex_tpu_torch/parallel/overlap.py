"""Overlapped gradient reduction: DDP buckets during the backward, and the
zero1 collectives in chunks.

Counterpart of ``apex_tpu/parallel/overlap.py``.  The reference apex DDP
hides the gradient wire behind the backward with per-parameter hooks that
fill ``message_size``-element buckets and all-reduce each as soon as it
fills (``apex/parallel/distributed.py:478-557``, ``comm_ready_buckets``).
The JAX package leaves the overlap to XLA's scheduler by issuing one
collective per bucket; here the hooks come back:

``HookedReduction`` (behind :meth:`~apex_tpu_torch.parallel.
DistributedDataParallel.grad`)
    puts a ``Tensor.register_hook`` on every leaf the backward takes
    gradients of.  A hook fires under ``torch.autograd.grad`` with the
    leaf's total gradient, copies it into its bucket's flat buffer and
    returns None.  Once every leaf of a bucket has arrived, and every
    earlier bucket has been launched, the bucket's collective is launched
    with ``async_op=True``: buckets launch in the static layout's order,
    so every rank issues the same collectives in the same order.  Buckets
    whose leaves got no gradient launch (zeros in those slots) after the
    backward returns.  ``work.wait()`` then orders the current stream
    after the collective's without a host sync; each bucket buffer lives
    until its wait.

:func:`bucketed_allreduce`
    the same buckets over gradients that already exist (no overlap, the
    same values): with ``fp32`` or no scheme it is bitwise equal to the
    deferred :func:`~apex_tpu_torch.parallel.distributed.allreduce_tree`
    (a sum is elementwise; concatenating leaves changes nothing);
    compressed schemes quantize bucket-wide blocks.  Residuals keep the
    gradients' leaf layout.

:func:`chunked_reduce_scatter` / :func:`segmented_allgather`
    the zero1 collectives (:class:`~apex_tpu_torch.parallel.weight_update.
    ShardedUpdate`) in column chunks of ~``message_size`` elements, bitwise
    equal to the whole-buffer collectives for fp32 and for int8 chunks on
    block multiples.

:func:`partition_buckets` is the JAX layout: the same leaf ids per bucket
and, with paths and dtypes spelled the JAX way, the same ``signature``.

Mode resolution (:func:`resolve_mode`): explicit ``overlap=`` >
``APEX_TPU_OVERLAP`` > the tuning profile's ``ddp_overlap``
(:data:`TUNING_KEY`, on the card only) > ``"off"``.  Adasum (its merge couples every element it reduces)
and callable per-leaf routing cannot stream per bucket
(:func:`can_stream`); the DDP falls back to the deferred path with a
one-time warning (:func:`warn_once`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from . import collectives as _coll
from .mesh import check_group_device, group_size, resolve_group
from ..multi_tensor_apply.flattener import LANE
from ..telemetry import events as _tel_events
from ..utils import tuning
from ..utils.pytree import (tree_flatten, tree_flatten_with_keystr,
                            tree_leaves, tree_unflatten)

__all__ = ["MODES", "ENV_KNOB", "TUNING_KEY", "DEFAULT_MESSAGE_SIZE",
           "resolve_mode", "can_stream", "warn_once",
           "Bucket", "BucketLayout", "partition_buckets",
           "bucketed_allreduce", "HookedReduction", "shard_chunk_bounds",
           "chunked_reduce_scatter", "segmented_allgather"]

MODES = ("off", "bucketed")
ENV_KNOB = "APEX_TPU_OVERLAP"
TUNING_KEY = "ddp_overlap"
#: the reference's bucket threshold, in elements (10M ~ 40 MB fp32)
DEFAULT_MESSAGE_SIZE = 10_000_000


def resolve_mode(mode: Optional[str] = None) -> str:
    """Explicit ``mode`` > ``APEX_TPU_OVERLAP`` > the tuning profile's
    ``ddp_overlap`` (on the card only) > ``"off"``."""
    if mode is None:
        env = os.environ.get(ENV_KNOB)
        if env is not None and env.strip():
            mode = env.strip().lower()
        else:
            mode = tuning.get_on_gpu(TUNING_KEY, "off")
    if mode not in MODES:
        raise ValueError(f"overlap must be one of {MODES}, got {mode!r}")
    return mode


_WARNED: set = set()


def warn_once(key, message: str) -> None:
    """``message`` once per process per ``key``."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(message)


def can_stream(scheme) -> bool:
    """Whether a scheme choice can reduce bucket by bucket: not adasum
    (self-scaling) and not a callable per-leaf routing.  ``None`` resolves
    the ambient choice, as the reduction will."""
    if callable(scheme):
        return False
    spec = _coll.resolve(scheme)
    if spec is None:
        return True
    return not _coll.get_scheme(spec.scheme).self_scaling


# ---------------------------------------------------------------------------
# bucket partitioning, from static tree facts alone
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Bucket:
    """One bucket: its leaves (ids in the forward flatten order), their
    paths, its elements and bytes."""
    index: int
    leaf_ids: Tuple[int, ...]
    paths: Tuple[str, ...]
    elems: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """A partition and its identity: ``signature`` hashes the (path, shape,
    dtype) sequence and the threshold, so ranks that agree on it hold the
    same layout (what the reference establishes by a rank-0 broadcast)."""
    buckets: Tuple[Bucket, ...]
    num_leaves: int
    message_size: int
    signature: str


def _leaf_facts(tree):
    """(paths, shapes, dtypes, sizes) in flat order; the dtypes spelled
    as the JAX package spells them."""
    leaves, paths, _ = tree_flatten_with_keystr(tree)
    shapes = [tuple(int(d) for d in l.shape) for l in leaves]
    dtypes = [_coll.dtype_name(l.dtype) for l in leaves]
    sizes = [int(math.prod(s)) if s else 1 for s in shapes]
    return paths, shapes, dtypes, sizes


def _greedy(order: Sequence[int], paths, sizes, nbytes,
            message_size: int) -> List[Bucket]:
    """Fill the current bucket in ``order`` and close it once it holds
    ``message_size`` elements; a large leaf overflows its bucket, the last
    may be smaller."""
    buckets: List[Bucket] = []
    cur: List[int] = []
    cur_elems = cur_bytes = 0
    for i in order:
        cur.append(i)
        cur_elems += sizes[i]
        cur_bytes += nbytes[i]
        if cur_elems >= message_size:
            buckets.append(Bucket(len(buckets), tuple(cur),
                                  tuple(paths[j] for j in cur),
                                  cur_elems, cur_bytes))
            cur, cur_elems, cur_bytes = [], 0, 0
    if cur:
        buckets.append(Bucket(len(buckets), tuple(cur),
                              tuple(paths[j] for j in cur),
                              cur_elems, cur_bytes))
    return buckets


def partition_buckets(tree, *, message_size: int = DEFAULT_MESSAGE_SIZE,
                      reverse: bool = True) -> BucketLayout:
    """Size-thresholded buckets of a tree's leaves, in reverse flat order
    (``reverse=True``: about the order the backward produces them).  A pure
    function of ((path, shape, dtype)...) and the threshold."""
    if int(message_size) <= 0:
        raise ValueError(f"message_size must be positive, got "
                         f"{message_size!r}")
    message_size = int(message_size)
    paths, shapes, dtypes, sizes = _leaf_facts(tree)
    nbytes = [sizes[i] * getattr(torch, dtypes[i]).itemsize
              for i in range(len(sizes))]
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets = _greedy(list(order), paths, sizes, nbytes, message_size)
    h = hashlib.sha256()
    h.update(repr((tuple(zip(paths, shapes, dtypes)), message_size,
                   bool(reverse))).encode())
    return BucketLayout(tuple(buckets), len(sizes), message_size,
                        h.hexdigest())


# ---------------------------------------------------------------------------
# the bucket engine: one flat buffer per bucket (per dtype without a
# scheme), an asynchronous collective per bucket, launched in layout order
# ---------------------------------------------------------------------------

def _scales(world, average, predivide_factor):
    """(pre, post) of the reference's ``allreduce_bucket``."""
    if predivide_factor is not None:
        return (1.0 / predivide_factor,
                predivide_factor / world if average else 1.0)
    return 1.0, (1.0 / world if average else 1.0)


class HookedReduction:
    """Bucketed all-reduce of one backward's gradients.

    ``leaves`` are the tensors the gradients belong to (templates: their
    shapes, dtypes and device).  :meth:`hook` gives the gradient hook of
    leaf ``i``; :meth:`put` takes a gradient directly.  A bucket launches
    once all its leaves are in and every earlier bucket has launched;
    :meth:`finish` launches what is left (leaves never put count as zero)
    and returns ``(reduced leaves, new residual leaves)``."""

    def __init__(self, leaves, paths, group, *, spec=None, average=True,
                 predivide_factor=None, always_fp32=False, residuals=None,
                 message_size: int = DEFAULT_MESSAGE_SIZE):
        self.group = group
        self.world = group_size(group)
        self.spec = spec
        self.pre, self.post = _scales(self.world, average, predivide_factor)
        self.metering = _tel_events.metering()
        n = len(leaves)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.orig_dtypes = [l.dtype for l in leaves]
        self.sizes = [int(l.numel()) for l in leaves]
        work_dt = [torch.float32 if spec is not None or (
            always_fp32 and dt != torch.float32) else dt
            for dt in self.orig_dtypes]
        device = leaves[0].device if n else torch.device("cpu")
        self.res_leaves = list(residuals) if residuals is not None else None
        nbytes = [self.sizes[i] * work_dt[i].itemsize for i in range(n)]
        self.buckets = _greedy(list(range(n - 1, -1, -1)), paths,
                               self.sizes, nbytes, int(message_size))
        # per bucket: {dtype: (buffer, [(leaf, offset)])}; leaf -> slot
        self.buffers: List[Dict[torch.dtype, Tuple[torch.Tensor, list]]] = []
        self.slot: Dict[int, Tuple[int, torch.dtype, int]] = {}
        for b in self.buckets:
            groups: Dict[torch.dtype, list] = {}
            for i in b.leaf_ids:
                groups.setdefault(work_dt[i], []).append(i)
            bufs = {}
            for dt, ids in groups.items():
                off, items = 0, []
                for i in ids:
                    items.append((i, off))
                    self.slot[i] = (b.index, dt, off)
                    off += self.sizes[i]
                bufs[dt] = (torch.empty(off, dtype=dt, device=device), items)
            self.buffers.append(bufs)
        self.pending = [len(b.leaf_ids) for b in self.buckets]
        self.arrived = [False] * n
        self.launched = 0
        #: the host-side order of hook arrivals and bucket launches:
        #: ("hook", leaf) / ("launch", bucket)
        self.events: List[Tuple[str, int]] = []
        # per bucket: {dtype: finish()} of its launched collectives, and
        # its new residual (flat, int8 error feedback)
        self._inflight: List[Dict[torch.dtype, Callable]] = [
            {} for _ in self.buckets]
        self._new_res: List[Optional[torch.Tensor]] = [None] * len(
            self.buckets)

    @property
    def launch_log(self) -> List[int]:
        """Bucket ids in launch order."""
        return [i for kind, i in self.events if kind == "launch"]

    # -- arrivals ------------------------------------------------------------

    def put(self, i: int, grad: Optional[torch.Tensor]) -> None:
        """Copy leaf ``i``'s gradient into its bucket and launch what is
        ready."""
        if self.arrived[i]:
            raise RuntimeError(f"leaf {i} got a second gradient in one "
                               "backward")
        b, dt, off = self.slot[i]
        view = self.buffers[b][dt][0][off:off + self.sizes[i]]
        if grad is None:
            view.zero_()
        else:
            view.copy_(grad.reshape(-1))
        self.arrived[i] = True
        self.pending[b] -= 1
        while self.launched < len(self.buckets) \
                and self.pending[self.launched] == 0:
            self._launch(self.launched)
            self.launched += 1

    def hook(self, i: int) -> Callable:
        def fn(grad):
            self.events.append(("hook", i))
            self.put(i, grad)
            return None
        return fn

    # -- launches ------------------------------------------------------------

    def _launch(self, b: int) -> None:
        t0 = time.perf_counter()
        self.events.append(("launch", b))
        bufs = self.buffers[b]
        ids = self.buckets[b].leaf_ids
        if self.spec is None:
            logical, dts = 0, set()
            for dt, (buf, _) in bufs.items():
                if self.pre != 1.0:
                    buf.mul_(self.pre)
                check_group_device(buf, self.group)
                work = dist.all_reduce(buf, op=dist.ReduceOp.SUM,
                                       group=self.group, async_op=True)
                self._inflight[b][dt] = self._plain_finish(buf, work)
                logical += buf.numel() * buf.element_size()
                dts.add(_coll.dtype_name(dt))
            if self.metering:
                self._record(logical, logical, len(ids), t0, None,
                             next(iter(dts)) if len(dts) == 1 else "mixed")
            return
        buf = bufs[torch.float32][0]
        if self.pre != 1.0:
            buf.mul_(self.pre)
        info = _coll.get_scheme(_coll.leaf_scheme(self.spec,
                                                  buf.numel() * 4))
        eff = dataclasses.replace(self.spec, scheme=info.name)
        rbuf = None
        if self.res_leaves is not None and info.stateful:
            rbuf = torch.cat([self.res_leaves[i].reshape(-1).float()
                              for i in ids])
        check_group_device(buf, self.group)
        finish, self._new_res[b] = _coll.launch_reduce(
            eff, buf, self.group, residual=rbuf)
        self._inflight[b][torch.float32] = finish
        if self.metering:
            self._record(buf.numel() * 4,
                         info.wire_bytes(buf.numel(), eff.block), len(ids),
                         t0, eff.scheme, info.wire_dtype)

    def _plain_finish(self, buf, work):
        def finish():
            work.wait()
            if self.post != 1.0:
                buf.mul_(self.post)
            return buf
        return finish

    def _record(self, logical, wire, n_leaves, t0, scheme, dtype):
        _tel_events.record_collective(
            _coll.axis_label(self.group), int(logical), n_leaves,
            time.perf_counter() - t0, wire_bytes=int(wire), dtype=dtype,
            scheme=scheme)

    # -- completion ----------------------------------------------------------

    def finish(self):
        """Launch the buckets not yet launched (in order, zeros for leaves
        that got no gradient), wait for every bucket and scatter the sums
        back to leaves.  Returns ``(leaves, residual leaves or None)``."""
        for i, done in enumerate(self.arrived):
            if not done:
                self.put(i, None)
        n = len(self.sizes)
        out: List[Optional[torch.Tensor]] = [None] * n
        out_res = list(self.res_leaves) if self.res_leaves is not None \
            else None
        for b in range(len(self.buckets)):
            red = {dt: finish() for dt, finish in self._inflight[b].items()}
            new_r = self._new_res[b]
            if self.spec is not None and self.post != 1.0:
                red[torch.float32] = red[torch.float32] * self.post
            for dt, (_, items) in self.buffers[b].items():
                flat = red[dt]
                for i, off in items:
                    out[i] = flat[off:off + self.sizes[i]].view(
                        self.shapes[i]).to(self.orig_dtypes[i])
                    if new_r is not None and out_res is not None:
                        out_res[i] = new_r[off:off + self.sizes[i]].view(
                            self.shapes[i])
            self._inflight[b], self._new_res[b] = {}, None
        return out, out_res


def bucketed_allreduce(grads, *, axis_name=None, average: bool = True,
                       predivide_factor: Optional[float] = None,
                       always_fp32: bool = False, scheme=None,
                       residuals=None,
                       min_compress_bytes: Optional[int] = None,
                       message_size: int = DEFAULT_MESSAGE_SIZE):
    """The bucketed counterpart of :func:`~apex_tpu_torch.parallel.
    distributed.allreduce_tree` over gradients that already exist: one
    collective per ``message_size``-element bucket in reverse flat order.
    With ``fp32`` or no scheme the result is bitwise the deferred path's;
    the residual tree keeps the gradients' leaf layout; the per-bucket
    meters' logical bytes sum to the deferred path's.  Adasum and
    callable schemes raise (gate on :func:`can_stream`)."""
    if callable(scheme):
        raise ValueError(
            "bucketed_allreduce cannot stream a callable per-leaf scheme; "
            "gate on can_stream() and use the deferred allreduce_tree")
    spec = _coll.resolve(scheme, min_bytes=min_compress_bytes)
    if spec is not None and _coll.get_scheme(spec.scheme).self_scaling:
        raise ValueError(
            f"collective scheme {spec.scheme!r} cannot stream per-bucket "
            "(its merge needs the full grad set); gate on can_stream() "
            "and use the deferred allreduce_tree")
    group = resolve_group(axis_name)
    if group is None:
        return grads if residuals is None else (grads, residuals)
    leaves, paths, treedef = tree_flatten_with_keystr(grads)
    res = tree_leaves(residuals) if residuals is not None else None
    eng = HookedReduction(leaves, paths, group, spec=spec, average=average,
                          predivide_factor=predivide_factor,
                          always_fp32=always_fp32, residuals=res,
                          message_size=message_size)
    for b in eng.buckets:
        for i in b.leaf_ids:
            eng.put(i, leaves[i])
    out, out_res = eng.finish()
    reduced = tree_unflatten(treedef, out)
    if residuals is None:
        return reduced
    return reduced, tree_unflatten(tree_flatten(residuals)[1], out_res)


# ---------------------------------------------------------------------------
# zero1 chunking: reduce-scatter per column chunk, all-gather per segment
# ---------------------------------------------------------------------------

def shard_chunk_bounds(per: int, message_size: int,
                       align: int) -> List[Tuple[int, int]]:
    """``[(a, b), ...)`` covering ``[0, per)``, every bound a multiple of
    ``align``, chunks of about ``message_size`` elements; one chunk when
    ``per`` is not ``align``-divisible or the threshold spans it."""
    per, align = int(per), max(1, int(align))
    if per <= 0:
        return []
    if per % align:
        return [(0, per)]
    step = max(1, int(message_size) // align) * align
    if step >= per:
        return [(0, per)]
    return [(a, min(a + step, per)) for a in range(0, per, step)]


def chunked_reduce_scatter(flat_g: torch.Tensor, group=None, spec=None, *,
                           residual: Optional[torch.Tensor] = None,
                           message_size: int = DEFAULT_MESSAGE_SIZE,
                           label: str = "ddp.reduce_scatter",
                           on_chunk: Optional[Callable] = None):
    """Reduce-scatter a full flat buffer in column chunks: viewed as
    ``(world, per)``, columns ``[a, b)`` of every rank form a sub-scatter
    whose result is exactly shard rows ``[a, b)``.  Bitwise the
    whole-buffer scatter for fp32, and for int8 when the bounds land on
    block multiples (otherwise one whole chunk runs).  ``residual`` is the
    canonical full-flat error-feedback buffer, sliced by column and
    reassembled.  ``on_chunk(logical, wire, seconds)`` meters each chunk.
    Returns ``(g_shard, new_residual, n_chunks)``."""
    world = group_size(group)
    per = flat_g.shape[0] // world
    align = LANE if spec is None or spec.scheme == "fp32" \
        else math.lcm(LANE, spec.block)
    bounds = shard_chunk_bounds(per, message_size, align)
    info = _coll.get_scheme(spec.scheme) if spec is not None else None

    def wire(n):
        return info.wire_bytes(n, spec.block) if info is not None else 4 * n

    if len(bounds) <= 1:
        t0 = time.perf_counter()
        shard, new_res = _coll.reduce_scatter_flat(
            flat_g, group, spec, residual=residual, label=label)
        if on_chunk is not None:
            on_chunk(flat_g.numel() * 4, wire(flat_g.numel()),
                     time.perf_counter() - t0)
        return shard, new_res, 1
    m = flat_g.view(world, per)
    rm = residual.view(world, per) if residual is not None else None
    shard_parts, res_parts = [], []
    for a, b in bounds:
        t0 = time.perf_counter()
        cbuf = m[:, a:b].reshape(-1)
        cres = rm[:, a:b].reshape(-1) if rm is not None else None
        cshard, cnew = _coll.reduce_scatter_flat(
            cbuf, group, spec, residual=cres, label=label)
        shard_parts.append(cshard)
        if rm is not None:
            res_parts.append((cres if cnew is None else cnew).view(
                world, b - a))
        if on_chunk is not None:
            on_chunk(cbuf.numel() * 4, wire(cbuf.numel()),
                     time.perf_counter() - t0)
    g_shard = torch.cat(shard_parts)
    if rm is None:
        return g_shard, residual, len(bounds)
    return g_shard, torch.cat(res_parts, dim=1).reshape(-1), len(bounds)


def segmented_allgather(shard: torch.Tensor, group=None, spec=None, *,
                        message_size: int = DEFAULT_MESSAGE_SIZE,
                        label: str = "ddp.param_allgather",
                        on_segment: Optional[Callable] = None):
    """All-gather an updated-param shard in segments; segment k's gather is
    ``concat_rank shard[a:b]``, and stacking each as ``(world, b - a)`` on
    the column axis rebuilds the canonical full buffer: bitwise the
    whole-shard gather for fp32 / bf16, and for int8 on block multiples.
    ``on_segment(logical, wire, seconds)`` meters each segment.  Returns
    ``(full, wire_bytes_total, wire_dtype, n_segments)``."""
    world = group_size(group)
    s = int(shard.shape[0])
    align = math.lcm(LANE, spec.block) if spec is not None \
        and spec.scheme == "int8_blockscale" else LANE
    bounds = shard_chunk_bounds(s, message_size, align)
    if len(bounds) <= 1:
        t0 = time.perf_counter()
        full, wire, dt = _coll.allgather_flat(shard, group, spec,
                                              label=label)
        if on_segment is not None:
            on_segment(s * 4, wire, time.perf_counter() - t0)
        return full, wire, dt, 1
    pieces, total_wire, dt = [], 0, "float32"
    for a, b in bounds:
        t0 = time.perf_counter()
        seg, wire, dt = _coll.allgather_flat(shard[a:b], group, spec,
                                             label=label)
        pieces.append(seg.view(world, b - a))
        total_wire += wire
        if on_segment is not None:
            on_segment((b - a) * 4, wire, time.perf_counter() - t0)
    full = torch.cat(pieces, dim=1).reshape(-1)
    return full, total_wire, dt, len(bounds)
