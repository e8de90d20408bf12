"""Mixed precision (counterpart of ``apex_tpu.amp``): ``initialize``,
``scale_loss``, ``amp_step``, the O0-O5 presets and the loss scaler."""
from . import scaler  # noqa: F401
from .frontend import (AmpState, amp_step, amp_step_multi,  # noqa: F401
                       initialize, master_params, scale_loss)
from .properties import Properties, opt_levels  # noqa: F401
from .scaler import ScalerState  # noqa: F401
