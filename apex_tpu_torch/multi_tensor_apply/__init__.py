"""Multi-tensor apply: the flat-buffer engine and its kernels
(counterpart of ``apex_tpu/multi_tensor_apply``)."""
from . import kernels  # noqa: F401
from .flattener import DEFAULT_CHUNK, LANE, TreeFlattener  # noqa: F401
from .kernels import (multi_tensor_l2norm,  # noqa: F401
                      multi_tensor_l2norm_reference)
