"""The training step of the port: one plain function.

    state = amp.initialize(params, FusedLAMB(..., impl="fused"),
                           opt_level="O5")
    for batch in batches:
        state, loss = train_step(state, batch, cfg)

Counterpart of the jitted step the JAX package's bench and graft entry
write out (``jax.grad`` of the scaled ``transformer_loss``, then
``amp.amp_step``): here ``transformer_loss`` -> ``amp.scale_loss`` ->
``torch.autograd.grad`` over the model parameters -> ``amp.amp_step``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import amp
from .models.transformer import TransformerConfig, transformer_loss
from .utils.pytree import tree_flatten, tree_unflatten

__all__ = ["train_step"]


def train_step(amp_state: amp.AmpState, batch: Dict[str, torch.Tensor],
               cfg: TransformerConfig, *,
               dropout_rng: Optional[torch.Generator] = None,
               smoothing: float = 0.0
               ) -> Tuple[amp.AmpState, torch.Tensor]:
    """One step: returns the new AmpState and the (unscaled) loss, a 0-d
    fp32 tensor on the model's device."""
    leaves, treedef = tree_flatten(amp_state.model_params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    params = tree_unflatten(treedef, leaves)
    loss = transformer_loss(params, batch, cfg, dropout_rng=dropout_rng,
                            smoothing=smoothing)
    scaled = amp.scale_loss(loss, amp_state)
    grads = torch.autograd.grad(scaled, leaves)
    new_state = amp.amp_step(amp_state, tree_unflatten(treedef, list(grads)))
    return new_state, loss.detach()
