"""Transformer multihead attention (counterpart of
``apex_tpu/contrib/multihead_attn``): the modules
:class:`SelfMultiheadAttn` / :class:`EncdecMultiheadAttn`, whose
``impl="fast"`` runs the flash kernels (:func:`flash_attention`) and
``impl="default"`` the plain PyTorch path; the functional mirrors
:func:`self_attn_func` / :func:`encdec_attn_func`; and
:func:`fast_mask_softmax_dropout_func`.  :func:`mha_params_from_jax`
carries a JAX module's parameters over."""
from .flash import flash_attention
from .functional import encdec_attn_func, self_attn_func
from .mask_softmax_dropout import fast_mask_softmax_dropout_func
from .modules import (EncdecMultiheadAttn, SelfMultiheadAttn,
                      mha_params_from_jax)

__all__ = [
    "SelfMultiheadAttn", "EncdecMultiheadAttn",
    "self_attn_func", "encdec_attn_func",
    "flash_attention", "fast_mask_softmax_dropout_func",
    "mha_params_from_jax",
]
