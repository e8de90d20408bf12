"""Mixed precision (counterpart of ``apex_tpu.amp``).

Entry points:
  - ``initialize(...)``: opt-level driven setup (O0-O5; O1 / O4 turn on
    the per-op casts);
  - ``scale_loss``, ``amp_step``, ``amp_step_multi``: loss scaling and the
    post-backward pipeline;
  - ``autocast(dtype)``, ``init`` / ``uninit``: the per-op casts of O1 / O4;
  - ``LossScaler`` and the ``scaler`` module: loss scaling as state;
  - the half / bfloat16 / float / promote decorators and registries;
  - the legacy handle API (``init_handle``).
"""
from . import scaler  # noqa: F401
from .scaler import LossScaler, ScalerState  # noqa: F401
from .handle import AmpHandle, NoOpHandle, OptimWrapper, init_handle  # noqa: F401
from .properties import Properties, opt_levels  # noqa: F401
from .amp import (  # noqa: F401
    init,
    uninit,
    is_initialized,
    autocast,
    disable_casts,
    half_function,
    bfloat16_function,
    float_function,
    promote_function,
    register_half_function,
    register_bfloat16_function,
    register_float_function,
    register_promote_function,
)
from .frontend import (  # noqa: F401
    initialize,
    scale_loss,
    amp_step,
    amp_step_multi,
    add_param_group,
    state_dict,
    load_state_dict,
    AmpState,
    master_params,
)
