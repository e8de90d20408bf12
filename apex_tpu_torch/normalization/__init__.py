from .fused_layer_norm import (FusedLayerNorm, fused_layer_norm,  # noqa: F401
                               fused_layer_norm_affine)
