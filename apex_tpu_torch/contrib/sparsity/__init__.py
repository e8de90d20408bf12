"""2:4 structured sparsity (reference: ``apex/contrib/sparsity``)."""
from .asp import ASP, SparseOptimizer
from .sparse_masklib import create_mask, m4n2_1d, mn_1d_best

__all__ = ["ASP", "SparseOptimizer", "create_mask", "mn_1d_best", "m4n2_1d"]
