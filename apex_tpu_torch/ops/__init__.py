"""Kernel wrappers: each launches its CUDA kernel for a CUDA tensor and
takes its plain PyTorch version for a CPU tensor."""
from .fused_mlp import (dense_act, fused_dense_act,  # noqa: F401
                        fused_dense_act_reference, mlp_pallas)
