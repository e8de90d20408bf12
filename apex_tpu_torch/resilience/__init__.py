"""apex_tpu_torch.resilience — fault injection, hardened checkpoints and
the self-resuming training guard.

Counterpart of ``apex_tpu/resilience``:

  * :mod:`~apex_tpu_torch.resilience.faults` — seeded, scheduled fault
    injection via config or ``APEX_TPU_FAULTS``;
  * :mod:`~apex_tpu_torch.resilience.ckpt` — :class:`CheckpointManager`:
    ``keep_last`` rotation and the manifest resume protocol over the
    CRC-framed ``apex_tpu_torch.checkpoint`` records, skipping corrupt or
    partial files;
  * :mod:`~apex_tpu_torch.resilience.guard` — :class:`TrainGuard`, the
    step runner with checkpoints on a writer thread, SIGTERM / SIGINT ->
    snapshot and clean exit, non-finite-streak and scaler-floor rollback
    and auto-resume (:class:`GuardConfig`, :class:`GuardReport`,
    :class:`GuardAbort`).
"""
from . import ckpt, faults, guard
from .ckpt import (MANIFEST, CheckpointManager, DataStreamMismatchError,
                   ManifestCompatWarning, WorldSizeMismatchError)
from .faults import (CollectiveFault, FaultError, FaultPlan, FaultSpec,
                     StallingIterator, active_plan, corrupt, install,
                     maybe_stall, parse, wrap_collective)
from .guard import GuardAbort, GuardConfig, GuardReport, TrainGuard
from ..checkpoint import CheckpointError
from ..data.loader import LoaderStallError

__all__ = [
    "ckpt", "faults", "guard",
    "TrainGuard", "GuardConfig", "GuardReport", "GuardAbort",
    "CheckpointManager", "MANIFEST", "CheckpointError",
    "DataStreamMismatchError", "ManifestCompatWarning",
    "WorldSizeMismatchError",
    "FaultPlan", "FaultSpec", "FaultError", "CollectiveFault",
    "StallingIterator", "parse", "install", "active_plan", "corrupt",
    "maybe_stall", "wrap_collective", "LoaderStallError",
]
