"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): ported,
:class:`FusedLAMB`, :class:`FusedAdam` and :class:`FusedSGD`; FusedAdagrad
and FusedNovoGrad are queued in ROADMAP.md."""
from ._base import FusedOptimizer, global_l2norm, resolve  # noqa: F401
from .fused_adam import (FusedAdam, FusedAdamState,  # noqa: F401
                         adam_state_from_jax)
from .fused_lamb import FusedLAMB, FusedLAMBState  # noqa: F401
from .fused_sgd import FusedSGD, FusedSGDState  # noqa: F401
