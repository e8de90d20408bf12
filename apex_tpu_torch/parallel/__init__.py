"""Distributed training over process groups (counterpart of
``apex_tpu/parallel``, a subset so far: process-group set-up and the grouped
scope, the collective schemes (:mod:`.collectives`), data-parallel gradient
reduction with its overlapped buckets (:mod:`.distributed`,
:mod:`.overlap`), weight-update sharding (:mod:`.weight_update`),
SyncBatchNorm and LARC; the device-mesh counterpart, ``multiproc`` and the
parallel engines are queued in ROADMAP.md)."""
import copy

from . import collectives, mesh, overlap, weight_update  # noqa: F401
from .collectives import CollectiveSpec  # noqa: F401
from .weight_update import ShardedUpdate  # noqa: F401
from .distributed import (DistributedDataParallel, Reducer,  # noqa: F401
                          allreduce_tree)
from .LARC import LARC  # noqa: F401
from .mesh import (GroupedMesh, create_grouped_mesh,  # noqa: F401
                   group_rank, group_size, initialize_distributed)
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
