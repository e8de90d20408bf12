"""Pipeline parallelism: GPipe-style microbatched stage execution.

Counterpart of ``apex_tpu/parallel/pipeline.py``.  Layers are partitioned
into S stages, one per rank of the ``pipe`` group; M microbatches stream
through a fill-drain schedule of ``M + S - 1`` ticks (stage ``s`` runs
microbatch ``m`` at tick ``m + s``); each tick's activation hops to the
next stage through :func:`~apex_tpu_torch.parallel.comm.shift_next`
(``batch_isend_irecv``), whose backward hops the gradient back, so
autograd gives the GPipe backward.

Every rank runs the same graph: stage 0 selects the injected microbatch
and the others what they received through a mask, as the JAX package's
``where`` does, and the outputs are the last stage's, masked elsewhere and
replicated by a differentiable sum over the pipe group.  Each rank's loss
is then its own term of the global objective: a loss computed from the
replicated outputs on one rank only (the others' masked to 0) is counted
exactly once.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import comm
from .mesh import group_rank, group_size, resolve_group
from ..utils.pytree import tree_map

__all__ = ["PIPE_AXIS", "pipeline_apply", "stack_stage_params",
           "unstack_local"]

PIPE_AXIS = "pipe"


def pipeline_apply(stage_fn: Callable, stage_params, x, *,
                   axis_name=PIPE_AXIS):
    """Run ``x`` (M, B, ...) microbatches through the S-stage pipeline of
    the ``axis_name`` group (a mesh axis name or a process group);
    ``stage_params`` are this rank's stage's.  ``stage_fn(params, h) ->
    h`` must keep the activation's shape.  Returns the (M, B, ...)
    outputs on every rank."""
    group = resolve_group(axis_name)
    S, idx = group_size(group), group_rank(group)
    M = x.shape[0]
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == S - 1, device=x.device)
    recv = torch.zeros_like(x[0])
    outs = []
    for t in range(M + S - 1):
        # stage 0 takes microbatch t (clamped; its tail ticks are never
        # read), the others what they received
        h_in = torch.where(first, x[min(t, M - 1)], recv)
        h_out = stage_fn(stage_params, h_in)
        if t >= S - 1:                   # the last stage finishes t-(S-1)
            outs.append(h_out)
        recv = comm.shift_next(h_out, group)
    out = torch.stack(outs)
    # only the last stage holds real outputs; the sum over the group
    # replicates them (every other rank contributes zeros)
    return comm.psum(torch.where(last, out, torch.zeros_like(out)), group)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] -> a tree with a leading S axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def unstack_local(stacked_local):
    """Strip the leading 1-axis of this rank's slice of a stage stack.
    Requires one stage per rank: a multi-stage slice is a different
    pipeline shape and must not be silently truncated."""
    def pick(l):
        if l.shape[0] != 1:
            raise ValueError(
                f"expected 1 local stage per device, got {l.shape[0]} — "
                "the number of stages must equal the pipe-axis size")
        return l[0]
    return tree_map(pick, stacked_local)
