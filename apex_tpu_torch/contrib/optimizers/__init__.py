"""Contrib optimizers (counterpart of ``apex_tpu/contrib/optimizers``):
the ZeRO sharded :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB`, :class:`FP16_Optimizer`, the flat fp16
master-weight wrapper of the fused optimizers, and :mod:`deprecated`, the
deprecated contrib FusedAdam / FusedLAMB / FusedSGD API."""
from .distributed_fused import (DistributedFusedAdam,  # noqa: F401
                                DistributedFusedLAMB, ShardedAdamState,
                                ShardedLAMBState, state_from_jax)
from .fp16_optimizer import FP16_Optimizer  # noqa: F401
from . import deprecated  # noqa: F401
