"""Distributed training over process groups (counterpart of
``apex_tpu/parallel``): process-group set-up, the named mesh and the
grouped scope (:mod:`.mesh`), the launcher (:mod:`.multiproc`), the
collective schemes (:mod:`.collectives`), data-parallel gradient reduction
with its overlapped buckets (:mod:`.distributed`, :mod:`.overlap`),
weight-update sharding (:mod:`.weight_update`), sequence, pipeline and
expert parallelism (:mod:`.sequence`, :mod:`.pipeline`, :mod:`.expert`
over the differentiable collectives of :mod:`.comm`), parallel plans and
their step engine with its tensor-parallel family and the planner's cost
model and search (:mod:`.plan`, :mod:`.spmd`), SyncBatchNorm and LARC."""
import copy

from . import (collectives, comm, expert, mesh, overlap,  # noqa: F401
               pipeline, plan, sequence, spmd, weight_update)
from .expert import EXPERT_AXIS, MoELayer, moe_ffn  # noqa: F401
from .pipeline import (PIPE_AXIS, pipeline_apply,  # noqa: F401
                       stack_stage_params, unstack_local)
from .plan import Plan, default_plan  # noqa: F401
from .sequence import (SequenceShardingError, ring_attention,  # noqa: F401
                       ulysses_attention, ulysses_flash_attention,
                       validate_sp)
from .spmd import build_plan_step  # noqa: F401
from .collectives import CollectiveSpec  # noqa: F401
from .weight_update import ShardedUpdate  # noqa: F401
from .distributed import (DistributedDataParallel, Reducer,  # noqa: F401
                          allreduce_tree)
from .LARC import LARC  # noqa: F401
from .mesh import (DATA_AXIS, GROUP_AXIS, MODEL_AXIS,  # noqa: F401
                   SEQ_AXIS, GroupedMesh, Mesh, Placement, axis_is_bound,
                   axis_size, bound_axes, create_grouped_mesh, create_mesh,
                   current_mesh, data_sharding, group_rank, group_size,
                   initialize_distributed, lax_axis_size, num_slices,
                   replicated, set_mesh, use_mesh)
from .sync_batchnorm import (SyncBatchNorm, batch_norm_stats,  # noqa: F401
                             sync_batch_norm)


def convert_syncbn_model(module, process_group=None, channel_last=True):
    """Recursively replace batch-norm-like modules with
    :class:`SyncBatchNorm`, the counterpart of
    ``apex.parallel.convert_syncbn_model``.

    Works over the port's plain-module trees (objects holding submodules as
    attributes or in lists, tuples and dicts).  A module is batch-norm-like
    when its class name contains "BatchNorm" but not "Sync" and it carries
    ``num_features`` (with ``eps``, ``momentum`` and optionally ``affine``
    and ``track_running_stats``).  Returns a new tree; the input is not
    mutated."""
    def conv(m):
        return convert_syncbn_model(m, process_group, channel_last)

    cls_name = type(module).__name__
    if ("BatchNorm" in cls_name and "Sync" not in cls_name
            and hasattr(module, "num_features")):
        return SyncBatchNorm(
            module.num_features, eps=module.eps, momentum=module.momentum,
            affine=getattr(module, "affine", True),
            track_running_stats=getattr(module, "track_running_stats", True),
            process_group=process_group, channel_last=channel_last)
    if isinstance(module, tuple):
        items = [conv(m) for m in module]
        if hasattr(module, "_fields"):      # a named tuple
            return type(module)(*items)
        return type(module)(items)
    if isinstance(module, list):
        return type(module)(conv(m) for m in module)
    if isinstance(module, dict):
        return type(module)((k, conv(v)) for k, v in module.items())
    # only the port's module objects are descended into
    if type(module).__module__.startswith("apex_tpu_torch") \
            and hasattr(module, "__dict__"):
        new = copy.copy(module)
        for k, v in vars(module).items():
            c = conv(v)
            if c is not v:
                setattr(new, k, c)
        return new
    return module


def create_syncbn_process_group(group_size):
    """This rank's process group of ``group_size`` consecutive ranks (the
    ``group`` of :func:`create_grouped_mesh`), to pass to
    :class:`SyncBatchNorm` as ``process_group``.  Collective: every rank of
    the default group calls it."""
    return create_grouped_mesh(group_size).group
