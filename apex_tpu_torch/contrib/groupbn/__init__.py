"""groupbn: NHWC batch norm with fused add + ReLU and group-scoped
statistics (counterpart of ``apex_tpu/contrib/groupbn``)."""
from .batch_norm import (BatchNorm2d_NHWC, bn_add_relu_nhwc,  # noqa: F401
                         bn_nhwc)

__all__ = ["BatchNorm2d_NHWC", "bn_nhwc", "bn_add_relu_nhwc"]
