"""Contrib optimizers (counterpart of ``apex_tpu/contrib/optimizers``):
the ZeRO sharded :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB`.  The fp16 optimizer is queued in
ROADMAP.md."""
from .distributed_fused import (DistributedFusedAdam,  # noqa: F401
                                DistributedFusedLAMB, ShardedAdamState,
                                ShardedLAMBState, state_from_jax)
