"""Process groups and a named mesh in place of the JAX package's device
mesh.

Counterpart of ``apex_tpu/parallel/mesh.py``.  Where the JAX package binds
mesh axes inside ``shard_map`` and asks ``psum(1, axis)`` for an axis size,
the port runs one process per card and passes ``torch.distributed``
process groups; :func:`group_size` and :func:`group_rank` answer the same
questions.

:func:`create_mesh` lays the ranks out as the JAX package lays devices out
(``devices.reshape(sizes)``, row-major, a ``-1`` wildcard), so rank ``r``
holds the data JAX device ``r`` holds, and gives this rank one process
group per axis: :meth:`Mesh.group` is the ranks that differ from this one
along that axis only.  :func:`use_mesh` makes a mesh ambient; an axis name
(a string) given where a process group is expected then resolves to the
ambient mesh's group for that axis (:func:`resolve_group`).

:func:`create_grouped_mesh` gives the JAX package's grouped scope (its
``(data, group)`` mesh) as ``torch.distributed.new_group`` subsets: a
collective over :attr:`GroupedMesh.group` stays inside this rank's group
of consecutive ranks, one over :attr:`GroupedMesh.data` crosses the groups.

The JAX package's ``shard_map`` has no counterpart: every rank already runs
the body of a step, on its own block of the data.  ``NamedSharding`` is
:class:`Placement`, a description of which dims split over which axes, with
:meth:`Placement.local` to take this rank's block of a global tensor.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["DATA_AXIS", "GROUP_AXIS", "MODEL_AXIS", "SEQ_AXIS",
           "initialize_distributed", "group_size", "group_rank",
           "check_group_device", "resolve_group", "GroupedMesh",
           "create_grouped_mesh", "Mesh", "create_mesh", "use_mesh",
           "set_mesh", "current_mesh", "axis_is_bound", "bound_axes",
           "axis_size", "lax_axis_size", "num_slices", "Placement",
           "replicated", "data_sharding"]

DATA_AXIS = "data"
GROUP_AXIS = "group"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"


def _env_int(name: str, default: int) -> int:
    val = os.environ.get(name)
    return default if val in (None, "") else int(val)


def initialize_distributed(*, init_file: Optional[str] = None,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None, device=None):
    """Start the default process group and return it: NCCL for a CUDA
    ``device`` (the default), gloo for the CPU.

    ``rank`` and ``world_size`` default to the launcher's ``RANK`` and
    ``WORLD_SIZE`` (``python -m apex_tpu_torch.parallel.multiproc``), else
    0 and 1.  ``init_file`` rendezvouses through a file (a ``FileStore``),
    which needs no network port: every rank passes the same path, and the
    file must not exist before the first rank starts.  Otherwise
    ``init_method`` (e.g. ``tcp://localhost:<port>``) or the
    ``MASTER_ADDR`` / ``MASTER_PORT`` environment.  With NCCL each rank
    takes the card ``LOCAL_RANK`` when the launcher set it, else ``rank %
    device_count()``."""
    dev = torch.device("cuda" if device is None else device)
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    rank = _env_int("RANK", 0) if rank is None else int(rank)
    world_size = (_env_int("WORLD_SIZE", 1) if world_size is None
                  else int(world_size))
    kw = {}
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK", rank)
        torch.cuda.set_device(local % torch.cuda.device_count())
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
    explicit group is kept; an axis name (a string, or a one-name tuple)
    is the ambient mesh's group for that axis (:func:`use_mesh`), and
    raises when no ambient mesh has it, as an unbound axis name does in
    the JAX package; ``None`` is the default group when torch.distributed
    is initialised (the JAX package's "every bound axis"), else no group
    (single-device semantics); an empty tuple or list is no group, as the
    JAX package's empty axis tuple ``()`` binds no axis."""
    if axis_name is None:
        return dist.group.WORLD if dist.is_available() \
            and dist.is_initialized() else None
    if isinstance(axis_name, (tuple, list)):
        if not axis_name:
            return None
        if len(axis_name) == 1 and isinstance(axis_name[0], str):
            axis_name = axis_name[0]
    if isinstance(axis_name, str):
        mesh = current_mesh()
        if mesh is None or axis_name not in mesh.shape:
            raise NameError(f"unbound axis name: {axis_name!r} is not an "
                            "axis of the ambient mesh (use_mesh)")
        return mesh.group(axis_name)
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


# ---------------------------------------------------------------------------
# the named mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a named mesh of ranks: the axis names and sizes
    (``shape``, in axis order), the mesh's global ranks in row-major order
    (``ranks``), this rank's coordinate on each axis and its process group
    along each axis, and ``world``, the group of every rank of the mesh."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    ranks: Tuple[int, ...]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    world: Any

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self.groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
        return self.coords[axis]


def _new_group(ranks):
    """A process group of ``ranks``; the default group when they are the
    whole world in order.  Collective over the default group."""
    if list(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def _resolve_sizes(axis_sizes: Optional[dict], n: int):
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: n}
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    fixed = math.prod(s for s in sizes if s != -1)
    if -1 in sizes:
        rem, mod = divmod(n, fixed)
        if mod:
            raise ValueError(f"{n} devices not divisible by fixed axes "
                             f"{fixed}")
        sizes = [rem if s == -1 else s for s in sizes]
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    return names, sizes


def create_mesh(axis_sizes: Optional[dict] = None,
                ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """A named mesh over all (or the given) ranks of the default group.

    ``axis_sizes`` maps axis name -> size, in order; -1 means "everything
    left" (default: one ``data`` axis over every rank).  Rank ``ranks[i]``
    sits at the row-major coordinate ``i`` of the sizes, the JAX package's
    ``devices.reshape(sizes)``.  Collective: every rank of the default
    group calls it (``torch.distributed.new_group`` is); a rank outside
    ``ranks`` gets None."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs torch.distributed: call "
                           "initialize_distributed first")
    ranks = (tuple(range(dist.get_world_size())) if ranks is None
             else tuple(int(r) for r in ranks))
    if list(ranks) != sorted(set(ranks)):
        # torch orders a group's ranks ascending: a coordinate is the group
        # rank only when the mesh's ranks ascend
        raise ValueError(f"mesh ranks must ascend, got {list(ranks)}")
    names, sizes = _resolve_sizes(axis_sizes, len(ranks))
    me = dist.get_rank()
    grid = torch.arange(len(ranks)).reshape(sizes)
    groups, coords = {}, {}
    for ax, name in enumerate(names):
        # every line of the grid along this axis, in a fixed order, so all
        # ranks create the same groups in the same order
        lines = grid.movedim(ax, -1).reshape(-1, sizes[ax])
        for line in lines.tolist():
            members = [ranks[i] for i in line]
            g = _new_group(members)
            if me in members:
                groups[name] = g
                coords[name] = members.index(me)
    world = _new_group(ranks)
    if me not in ranks:
        return None
    return Mesh(axis_names=tuple(names), shape=dict(zip(names, sizes)),
                ranks=ranks, coords=coords, groups=groups, world=world)


_current_mesh: Optional[Mesh] = None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh for the duration of the context."""
    global _current_mesh
    prev = _current_mesh
    _current_mesh = mesh
    try:
        yield mesh
    finally:
        _current_mesh = prev


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _current_mesh
    _current_mesh = mesh


def current_mesh() -> Optional[Mesh]:
    return _current_mesh


def axis_is_bound(axis_name) -> bool:
    """True when ``axis_name`` (or every name in a tuple) is an axis of
    the ambient mesh — the JAX package's "bound by an enclosing
    shard_map", the single source of the "collective or single-device?"
    decision."""
    names = (axis_name if isinstance(axis_name, (tuple, list))
             else (axis_name,))
    mesh = current_mesh()
    return mesh is not None and all(n in mesh.shape for n in names)


def bound_axes(*names) -> tuple:
    """The subset of ``names`` currently bound (ordered as given)."""
    return tuple(n for n in names if axis_is_bound(n))


def axis_size(axis_name: str, mesh: Optional[Mesh] = None) -> int:
    """``axis_name``'s size in ``mesh`` (default the ambient one); 1 when
    there is no mesh or no such axis."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis_name, 1))


def lax_axis_size(axis_name) -> int:
    """The size of the group an axis name (or a process group) resolves
    to — ``jax.lax.axis_size`` of a bound axis.  An unbound name raises."""
    return group_size(resolve_group(axis_name))


def num_slices(ranks: Optional[Sequence[int]] = None) -> int:
    """Distinct hosts among ``ranks`` (default: every rank): collectives
    that cross hosts leave NVLink, as the JAX package's cross-slice ones
    leave ICI.  Collective over the default group when torch.distributed
    is initialised; 1 otherwise."""
    if not dist.is_available() or not dist.is_initialized():
        return 1
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    if ranks is not None:
        hosts = [hosts[int(r)] for r in ranks]
    return len(set(hosts)) or 1


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a global tensor's blocks live on ``mesh``: ``spec[i]`` names
    the axis (or tuple of axes, major first) that dim ``i`` splits over,
    None for a dim every rank holds whole — a ``PartitionSpec``.  An empty
    spec is replicated."""
    mesh: Mesh
    spec: Tuple[Any, ...] = ()

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``t``."""
        for dim, axes in enumerate(self.spec):
            if axes is None:
                continue
            axes = (axes,) if isinstance(axes, str) else tuple(axes)
            n = math.prod(self.mesh.shape[a] for a in axes)
            idx = 0
            for a in axes:
                idx = idx * self.mesh.shape[a] + self.mesh.coords[a]
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {t.shape[dim]} does "
                                 f"not split over {axes} ({n})")
            per = t.shape[dim] // n
            t = t.narrow(dim, idx * per, per)
        return t


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def data_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> Placement:
    """Shard the leading (batch) dim over the data axis."""
    return Placement(mesh, (axis,))


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
