"""Fused optimizers (counterpart of ``apex_tpu/optimizers``).  Ported so
far: :class:`FusedLAMB`; FusedAdam, FusedSGD, FusedAdagrad and
FusedNovoGrad are queued in ROADMAP.md."""
from ._base import FusedOptimizer, global_l2norm, resolve  # noqa: F401
from .fused_lamb import FusedLAMB, FusedLAMBState  # noqa: F401
