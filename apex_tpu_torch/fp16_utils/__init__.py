"""Legacy manual mixed precision (counterpart of ``apex_tpu/fp16_utils``,
the reference's ``apex/fp16_utils``): the parameter-list helpers of
``fp16util`` (param-list prep, master <-> model copies,
``network_to_half`` / ``convert_network``, ``tofp16``), the legacy per-leaf
:class:`FP16_Optimizer` and the static / dynamic loss scalers, all over
:mod:`apex_tpu_torch.amp.scaler`.  The legacy defaults differ from amp's:
init scale 2**32, window 1000.

This is not the contrib flat ``FP16_Optimizer``
(:mod:`apex_tpu_torch.contrib.optimizers`)."""
from .fp16util import (  # noqa: F401
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    tofp16,
)
from .fp16_optimizer import FP16_Optimizer  # noqa: F401
from .loss_scaler import DynamicLossScaler, LossScaler  # noqa: F401
