"""Fused optimizers (counterpart of ``apex_tpu/optimizers``): all five of
the JAX package's, :class:`FusedLAMB`, :class:`FusedAdam`,
:class:`FusedSGD`, :class:`FusedNovoGrad` and :class:`FusedAdagrad`, each
with both impls (``"xla"`` per leaf, ``"fused"`` on the flat engine)."""
from ._base import FusedOptimizer, global_l2norm, resolve  # noqa: F401
from .fused_adagrad import (FusedAdagrad, FusedAdagradState,  # noqa: F401
                            adagrad_state_from_jax)
from .fused_adam import (FusedAdam, FusedAdamState,  # noqa: F401
                         adam_state_from_jax)
from .fused_lamb import FusedLAMB, FusedLAMBState  # noqa: F401
from .fused_novograd import (FusedNovoGrad,  # noqa: F401
                             FusedNovoGradState, novograd_state_from_jax)
from .fused_sgd import FusedSGD, FusedSGDState  # noqa: F401
