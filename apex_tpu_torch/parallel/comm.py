"""Differentiable collectives: the JAX package's ``lax.ppermute``,
``lax.all_to_all`` (``tiled=True``) and ``lax.psum`` as
``torch.autograd.Function``\\ s whose backward is the transposed
collective, so autograd differentiates a sequence-, pipeline- or
expert-parallel body as JAX differentiates it.

Every rank of the group must reach each collective, forward and backward,
in the same order: the bodies that use these keep one graph structure on
every rank (masks in place of rank-dependent branches) so that autograd
runs the same backward collectives everywhere.

- :func:`rotate` — the cyclic ``ppermute`` ``i -> i + shift``; it rides
  ``all_to_all_single`` with uneven splits (each rank's whole block to one
  peer), which every backend carries at every world size, world 1
  included (gloo refuses a send to oneself).  Backward: the reverse
  rotation.
- :func:`all_to_all` — tiled ``all_to_all`` (split one dim over the
  group, concatenate the received blocks along another).  Backward: the
  inverse exchange.  ``meter`` names a telemetry family: each exchange,
  forward and backward, is then recorded through
  :func:`~apex_tpu_torch.telemetry.events.record_collective`.
- :func:`shift_next` — the non-cyclic neighbour hop ``i -> i + 1`` of a
  pipeline (``batch_isend_irecv``, so no rank waits on its own send);
  rank 0 receives zeros.  Backward: the hop back.
- :func:`psum` — all-reduce sum.  Backward: the all-reduce of the
  cotangents (each rank's loss is its own term of the global objective).
- :func:`copy_to_tp` / :func:`reduce_from_tp` — Megatron's conjugate
  pair for a column / row split over the tensor-parallel group: the
  first is the identity forward and an all-reduce of the cotangents
  backward (*f*), the second an all-reduce forward and the identity
  backward (*g*).
- :func:`gather_from_tp` — all-gather along a dim (the vocab-sharded
  logits a sampler reads whole); backward: this rank's slice.
- :func:`all_reduce_stat` — a non-differentiable all-reduce (sum or max)
  of statistics, such as a vocab-parallel cross-entropy's row maxima.

:func:`recording` collects what these collectives ship, forward and
backward, by the compiled program's opcode names (``all-to-all``,
``collective-permute``, ``all-reduce``): the meter of an executed step,
where the JAX package reads its compiled program.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import check_group_device

__all__ = ["rotate", "all_to_all", "shift_next", "psum", "copy_to_tp",
           "reduce_from_tp", "gather_from_tp", "all_reduce_stat",
           "recording"]

_TAPE: Optional[dict] = None


@contextlib.contextmanager
def recording():
    """Collect ``{opcode: {"count", "logical_bytes"}}`` of this rank's
    collectives from this module while the context is open (per-rank
    payloads, as the JAX package's compiled-HLO table counts them)."""
    global _TAPE
    prev, _TAPE = _TAPE, {}
    try:
        yield _TAPE
    finally:
        _TAPE = prev


def _note(opcode: str, t: torch.Tensor) -> None:
    if _TAPE is not None:
        agg = _TAPE.setdefault(opcode, {"count": 0, "logical_bytes": 0})
        agg["count"] += 1
        agg["logical_bytes"] += t.numel() * t.element_size()


def _meter(family: Optional[str], group, t: torch.Tensor, op: str,
           seconds: float) -> None:
    _note("all-to-all" if op == "all_to_all" else op, t)
    if family is None:
        return
    from ..telemetry import events as _events
    if not _events.metering():
        return
    from .collectives import axis_label, dtype_name
    nbytes = t.numel() * t.element_size()
    _events.record_collective(axis_label(group), nbytes, 1, seconds,
                              wire_bytes=nbytes, scheme="fp32",
                              dtype=dtype_name(t.dtype), op=op,
                              family=family)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    check_group_device(x, group)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = x.contiguous().reshape(-1)
    sizes_in = [0] * n
    sizes_out = [0] * n
    sizes_in[(me + shift) % n] = flat.numel()
    sizes_out[(me - shift) % n] = flat.numel()
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, sizes_out, sizes_in, group=group)
    _note("collective-permute", flat)
    return out.reshape(x.shape)


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.group, -ctx.shift), None, None


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rank ``i``'s ``x`` arrives at rank ``(i + shift) % n`` of
    ``group`` (``lax.ppermute`` with the cyclic permutation)."""
    return _Rotate.apply(x, group, shift)


def _a2a(x: torch.Tensor, group, split_axis: int, concat_axis: int,
         family: Optional[str]) -> torch.Tensor:
    check_group_device(x, group)
    n = dist.get_world_size(group)
    shp = list(x.shape)
    if shp[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size "
                         f"{shp[split_axis]} does not split over {n} ranks")
    blocks = x.reshape(shp[:split_axis] + [n, shp[split_axis] // n]
                       + shp[split_axis + 1:]).movedim(split_axis, 0)
    blocks = blocks.contiguous()
    out = torch.empty_like(blocks)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, blocks, group=group)
    _meter(family, group, blocks, "all_to_all", time.perf_counter() - t0)
    # out[i] is source rank i's block; concatenate them along concat_axis
    piece = list(out.shape[1:])
    return out.movedim(0, concat_axis).reshape(
        piece[:concat_axis] + [n * piece[concat_axis]]
        + piece[concat_axis + 1:])


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, family):
        ctx.args = (group, split_axis, concat_axis, family)
        return _a2a(x, group, split_axis, concat_axis, family)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis, family = ctx.args
        return (_a2a(g, group, concat_axis, split_axis, family), None, None,
                None, None)


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               meter: Optional[str] = None) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: dim ``split_axis`` splits into n blocks, block ``j``
    goes to rank ``j``, and the blocks received concatenate along
    ``concat_axis`` in rank order."""
    return _AllToAll.apply(x, group, split_axis, concat_axis, meter)


def _hop(x: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """Send ``x`` one rank up (``forward``) or down the chain and return
    what arrives from the other side; zeros at the end that has no
    neighbour."""
    check_group_device(x, group)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    src, dst = (me - 1, me + 1) if forward else (me + 1, me - 1)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, dst), group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if 0 <= dst < n:
        _note("collective-permute", x)
    return out


class _ShiftNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _hop(x, group, True)

    @staticmethod
    def backward(ctx, g):
        return _hop(g, ctx.group, False), None


def shift_next(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, i + 1) for i < n - 1])``: rank ``i``
    receives rank ``i - 1``'s ``x``; rank 0 receives zeros and the last
    rank's ``x`` goes nowhere."""
    return _ShiftNext.apply(x, group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        check_group_device(x, group)
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        _note("all-reduce", out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        _note("all-reduce", g)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """``lax.psum(x, axis)``, differentiable."""
    return _Psum.apply(x, group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    check_group_device(x, group)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    _note("all-reduce", out)
    return out


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` as it is forward; the cotangents of the
    ranks' column shards summed over ``group`` backward (each rank's
    column slice gives a partial gradient of the replicated input)."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the ranks' partial sums of a row-split product
    summed over ``group`` forward; the cotangent passed through backward
    (every rank's output is the same replicated tensor)."""
    return _ReduceFromTp.apply(x, group)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    check_group_device(x, group)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts, dim)
    _note("all-gather", out)
    return out


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, me * ctx.size, ctx.size), None, None


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    bits are the same on every rank); backward: this rank's slice."""
    return _GatherFromTp.apply(x, group, dim % x.dim())


def all_reduce_stat(x: torch.Tensor, group, op: str = "sum"
                    ) -> torch.Tensor:
    """``x`` (no gradient) reduced over ``group`` by ``op`` (``"sum"`` or
    ``"max"``): statistics such as a vocab-parallel cross-entropy's row
    maxima and sums of exponentials."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
    return _all_reduce(x.detach(), group, ops[op])
