"""Flat-buffer collectives of the ZeRO optimizers.

Counterpart of ``apex_tpu/parallel/collectives.py``, a subset: the
:class:`CollectiveSpec` and :func:`resolve` of an explicit scheme argument,
and the two flat lowerings the sharded optimizers ride on —
:func:`reduce_scatter_flat` (``fp32``: a summing reduce-scatter) and
:func:`allgather_flat` (``fp32``, and ``bf16``: the shard cast to bf16,
gathered, cast back to fp32).  The compressed and adaptive reduce-scatter
schemes (``bf16``, ``int8_blockscale``, ``adasum``), the
error-feedback residual, the ``APEX_TPU_COLLECTIVES`` environment knob,
the live override and the wire meter are not ported yet (ROADMAP.md):
asking for a scheme that is not lowered raises.

A CUDA tensor goes over NCCL only (:func:`~apex_tpu_torch.parallel.mesh.
check_group_device`); nothing here copies device data through the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import check_group_device, group_size

__all__ = ["CollectiveSpec", "SCHEMES", "resolve", "reduce_scatter_flat",
           "allgather_flat"]

# PyTorch renamed the flat collectives (the old names warn in newer
# releases); the same arguments either way
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

#: the JAX package's registered schemes; the port lowers only
#: :data:`_PORTED_RS` / :data:`_PORTED_AG` of them so far
SCHEMES = ("adasum", "bf16", "fp32", "int8_blockscale")
_PORTED_RS = ("fp32",)
_PORTED_AG = ("fp32", "bf16")


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """A resolved scheme choice.  The JAX package's quantization block and
    byte threshold come with the int8 scheme that reads them."""
    scheme: str = "fp32"


def resolve(scheme=None) -> Optional[CollectiveSpec]:
    """An explicit scheme (a name or a :class:`CollectiveSpec`) -> a spec;
    None stays None (the plain fp32 collective).  The JAX package's
    further sources (live override, environment, tuning profile) are not
    ported."""
    if scheme is None or isinstance(scheme, CollectiveSpec):
        return scheme
    if scheme not in SCHEMES:
        raise ValueError(f"unknown collective scheme {scheme!r}; known: "
                         f"{SCHEMES}")
    return CollectiveSpec(scheme)


def _not_ported(what: str, scheme: str):
    return NotImplementedError(
        f"the {scheme!r} {what} scheme is not ported yet (the port lowers "
        f"{_PORTED_RS if what == 'reduce-scatter' else _PORTED_AG}); see "
        "ROADMAP.md")


def _check_flat(x: torch.Tensor, group, what: str) -> int:
    if x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 1-D buffer, got "
                         f"{tuple(x.shape)}")
    check_group_device(x, group)
    return group_size(group)


def reduce_scatter_flat(x: torch.Tensor, group=None,
                        spec: Optional[CollectiveSpec] = None
                        ) -> torch.Tensor:
    """Sum-reduce-scatter a 1-D buffer over ``group``: every rank gives
    its full local buffer and receives its contiguous 1/world slice of
    the element-wise sum.  The caller owns pre/post scaling.  Only the
    plain ``fp32`` scheme is ported."""
    if spec is not None and spec.scheme not in _PORTED_RS:
        raise _not_ported("reduce-scatter", spec.scheme)
    world = _check_flat(x, group, "reduce_scatter_flat")
    if x.numel() % world:
        raise ValueError(f"buffer of {x.numel()} does not split over "
                         f"{world} ranks")
    shard = torch.empty(x.numel() // world, dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(shard, x, op=dist.ReduceOp.SUM, group=group)
    return shard


def allgather_flat(x: torch.Tensor, group=None,
                   spec: Optional[CollectiveSpec] = None) -> torch.Tensor:
    """Gather each rank's 1-D shard into the full concatenated fp32
    buffer.  ``spec`` ``bf16`` ships bf16 (the shard rounded once) and
    casts back."""
    if spec is not None and spec.scheme == "adasum":
        raise ValueError("adasum is a reduction rule; it has no "
                         "allgather meaning")
    if spec is not None and spec.scheme not in _PORTED_AG:
        raise _not_ported("allgather", spec.scheme)
    world = _check_flat(x, group, "allgather_flat")
    wire = x.to(torch.bfloat16) if spec is not None \
        and spec.scheme == "bf16" else x
    full = torch.empty(world * wire.numel(), dtype=wire.dtype,
                       device=x.device)
    _ALL_GATHER(full, wire, group=group)
    return full.to(torch.float32)
