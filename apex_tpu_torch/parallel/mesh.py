"""Process groups in place of the JAX package's device mesh.

Counterpart of ``apex_tpu/parallel/mesh.py``, a subset: where the JAX
package binds mesh axes inside ``shard_map`` and asks ``psum(1, axis)``
for an axis size, the port runs one process per card and passes
``torch.distributed`` process groups; :func:`group_size` and
:func:`group_rank` answer the same questions.  No ``Mesh`` or
``NamedSharding`` counterpart yet (ROADMAP.md).

:func:`create_grouped_mesh` gives the JAX package's grouped scope (its
``(data, group)`` mesh) as ``torch.distributed.new_group`` subsets: a
collective over :attr:`GroupedMesh.group` stays inside this rank's group
of consecutive ranks, one over :attr:`GroupedMesh.data` crosses the groups.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "group_size", "group_rank",
           "check_group_device", "resolve_group", "GroupedMesh",
           "create_grouped_mesh"]


def initialize_distributed(*, init_file: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: int = 0, world_size: int = 1, device=None):
    """Start the default process group and return it: NCCL for a CUDA
    ``device`` (the default), gloo for the CPU.

    ``init_file`` rendezvouses through a file (a ``FileStore``), which
    needs no network port: every rank passes the same path, and the file
    must not exist before the first rank starts.  Otherwise
    ``init_method`` (e.g. ``tcp://localhost:<port>``) or the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment.  With NCCL each rank
    takes the card ``rank % device_count()``."""
    dev = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
    if init_file is not None:
        kw["store"] = dist.FileStore(os.fspath(init_file), world_size)
    else:
        kw["init_method"] = init_method
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            rank=rank, world_size=world_size, **kw)
    return dist.group.WORLD


def group_size(group=None) -> int:
    """Number of ranks in ``group`` (None: the default group) — the JAX
    package's ``psum(1, axis)``."""
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This process's rank inside ``group`` — the JAX package's
    ``axis_index(axis)``."""
    return dist.get_rank(group)


def resolve_group(axis_name=None):
    """The process group a collective runs over, or None for none: an
    explicit group is kept; ``None`` is the default group when
    torch.distributed is initialised (the JAX package's "every bound
    axis"), else no group (single-device semantics); an empty tuple or
    list is no group, as the JAX package's empty axis tuple ``()`` binds
    no axis."""
    if axis_name is None:
        return dist.group.WORLD if dist.is_available() \
            and dist.is_initialized() else None
    if isinstance(axis_name, (tuple, list)) and not axis_name:
        return None
    return axis_name


def check_group_device(t: torch.Tensor, group=None) -> None:
    """Raise unless ``group``'s backend carries ``t``'s device: a CUDA
    tensor needs NCCL (it must not move through host memory), a CPU tensor
    a backend other than NCCL alone."""
    backend = str(dist.get_backend(group))
    if t.is_cuda and "nccl" not in backend:
        raise RuntimeError(
            f"a CUDA tensor on a process group with backend {backend!r}: "
            "the port's collectives run CUDA tensors over NCCL only and "
            "never copy them through the host")
    if not t.is_cuda and backend == "nccl":
        raise RuntimeError(
            f"a {t.device} tensor on an NCCL process group: give CPU "
            "tensors a gloo group")


@dataclasses.dataclass(frozen=True)
class GroupedMesh:
    """This rank's two process groups of a world split into groups of
    ``group_size`` consecutive ranks: ``group`` (its own group, the JAX
    package's ``group`` axis) and ``data`` (the ranks at its position in
    every group, the ``data`` axis)."""
    group: Any
    data: Any


def create_grouped_mesh(group_size: int) -> GroupedMesh:
    """Split the default group into contiguous groups of ``group_size``
    ranks (``create_grouped_mesh``'s layout: rank = data * group_size +
    group).  Collective: every rank of the default group calls it."""
    world = dist.get_world_size()
    if group_size <= 0 or world % group_size:
        raise ValueError(f"group_size {group_size} must divide world size "
                         f"{world}")
    rank = dist.get_rank()
    groups = [dist.new_group(list(range(g * group_size,
                                        (g + 1) * group_size)))
              for g in range(world // group_size)]
    datas = [dist.new_group(list(range(i, world, group_size)))
             for i in range(group_size)]
    return GroupedMesh(group=groups[rank // group_size],
                       data=datas[rank % group_size])
