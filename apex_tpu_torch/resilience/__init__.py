"""apex_tpu_torch.resilience — fault injection and hardened checkpoints.

Counterpart of ``apex_tpu/resilience``:

  * :mod:`~apex_tpu_torch.resilience.faults` — seeded, scheduled fault
    injection via config or ``APEX_TPU_FAULTS``;
  * :mod:`~apex_tpu_torch.resilience.ckpt` — :class:`CheckpointManager`:
    ``keep_last`` rotation and the manifest resume protocol over the
    CRC-framed ``apex_tpu_torch.checkpoint`` records, skipping corrupt or
    partial files.

The JAX package's ``guard`` (``TrainGuard``, ``GuardConfig``,
``GuardReport``, ``GuardAbort``) is not ported yet; its names join this
module's exports when it is.
"""
from . import ckpt, faults
from .ckpt import (MANIFEST, CheckpointManager, DataStreamMismatchError,
                   ManifestCompatWarning, WorldSizeMismatchError)
from .faults import (CollectiveFault, FaultError, FaultPlan, FaultSpec,
                     StallingIterator, active_plan, corrupt, install,
                     maybe_stall, parse, wrap_collective)
from ..checkpoint import CheckpointError
from ..data.loader import LoaderStallError

__all__ = [
    "ckpt", "faults",
    "CheckpointManager", "MANIFEST", "CheckpointError",
    "DataStreamMismatchError", "ManifestCompatWarning",
    "WorldSizeMismatchError",
    "FaultPlan", "FaultSpec", "FaultError", "CollectiveFault",
    "StallingIterator", "parse", "install", "active_plan", "corrupt",
    "maybe_stall", "wrap_collective", "LoaderStallError",
]
