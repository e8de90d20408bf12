"""Fused MLP (counterpart of ``apex_tpu.mlp``): :class:`MLP` and
:func:`mlp_function`, every layer through the fused dense kernel."""
from .mlp import MLP, mlp_function, mlp_params_from_jax  # noqa: F401
