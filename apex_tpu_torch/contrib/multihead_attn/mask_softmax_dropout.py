"""Masked softmax + dropout over materialized scores.

Counterpart of ``apex_tpu/contrib/multihead_attn/mask_softmax_dropout.py``
(the reference's ``fast_mask_softmax_dropout_func``).  The JAX package
computes it as plain XLA (no Pallas kernel), so here it is plain PyTorch;
the flash path never materializes the scores at all.
"""
from __future__ import annotations

import torch

from .functional import Rng, bernoulli_keep

__all__ = ["fast_mask_softmax_dropout_func"]


def fast_mask_softmax_dropout_func(is_training, heads, inputs, pad_mask,
                                   mask_additive, dropout_prob,
                                   dropout_rng: Rng = None) -> torch.Tensor:
    """inputs (B*H, Sq, Sk) attention scores; pad_mask (B, Sk) bool
    (nonzero = pad) or additive float; returns the dropped softmax
    probabilities in the input's dtype.  ``dropout_rng`` as
    :func:`~apex_tpu_torch.contrib.multihead_attn.functional.bernoulli_keep`
    takes it."""
    BH, Sq, Sk = inputs.shape
    s = inputs.float()
    if pad_mask is not None:
        B = pad_mask.shape[0]
        if mask_additive:
            m = pad_mask.float().reshape(B, 1, 1, Sk)
        else:
            m = torch.where(pad_mask.bool(),
                            torch.full((), float("-inf"),
                                       device=pad_mask.device),
                            torch.zeros((), device=pad_mask.device)
                            ).reshape(B, 1, 1, Sk)
        s = (s.reshape(B, BH // B, Sq, Sk) + m).reshape(BH, Sq, Sk)
    p = torch.softmax(s, dim=-1)
    if is_training and dropout_prob > 0.0 and dropout_rng is not None:
        keep = bernoulli_keep(p.shape, 1.0 - dropout_prob, dropout_rng,
                              p.device)
        p = p * keep / (1.0 - dropout_prob)
    return p.to(inputs.dtype)
