"""Opt-in extensions (reference: ``apex/contrib``), as the JAX package's
``apex_tpu.contrib`` lays them out."""
from . import groupbn, multihead_attn, optimizers, sparsity, xentropy

__all__ = ["xentropy", "multihead_attn", "optimizers", "sparsity", "groupbn"]
