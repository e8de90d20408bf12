"""Rank-0-gated logging: ``rank``, ``is_rank0``, ``maybe_print`` and the
one-time warning latch ``warn_once``.

Counterpart of the JAX package's ``apex_tpu/utils/logging.py``: the rank
comes from ``torch.distributed`` when a default process group is
initialised, else 0.  The meters it re-exports (``AverageMeter``,
``Throughput``) live in :mod:`apex_tpu_torch.telemetry.registry`, and
are resolved on first access so importing this module never imports the
telemetry package.
"""
from __future__ import annotations

import sys
from typing import Optional

_warned: set = set()


def rank() -> int:
    """This process's rank in the default ``torch.distributed`` group, or
    0 when none is initialised."""
    try:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:  # pragma: no cover - a half-torn-down group
        pass
    return 0


def is_rank0() -> bool:
    return rank() == 0


def maybe_print(msg: str, *, rank0_only: bool = True, file=None) -> None:
    """Print ``msg`` unless gated off-rank."""
    if not rank0_only or is_rank0():
        print(msg, file=file or sys.stdout, flush=True)


def warn_once(key: str, msg: Optional[str] = None) -> bool:
    """One-time warning latch.  Returns True the first time ``key`` is
    seen (and prints ``msg`` if given, rank 0 only)."""
    if key in _warned:
        return False
    _warned.add(key)
    if msg is not None:
        maybe_print(msg, file=sys.stderr)
    return True


def __getattr__(name):
    if name in ("AverageMeter", "Throughput"):
        from ..telemetry import registry as _tr
        return getattr(_tr, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
