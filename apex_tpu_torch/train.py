"""The training steps of the port: plain functions.

    state = amp.initialize(params, FusedLAMB(..., impl="fused"),
                           opt_level="O5")
    for batch in batches:
        state, loss = train_step(state, batch, cfg)

:func:`train_step` is the counterpart of the jitted step the JAX package's
bench and graft entry write out (``jax.grad`` of the scaled
``transformer_loss``, then ``amp.amp_step``): here ``transformer_loss`` ->
``amp.scale_loss`` -> ``torch.autograd.grad`` over the model parameters ->
``amp.amp_step``.

:func:`zero_train_step` is the inner step of the JAX BERT example's
``--zero`` mode (``examples/bert/pretrain.py`` ``run_zero``), one process
per rank::

    initialize_distributed(init_file=..., rank=r, world_size=n)
    opt = DistributedFusedLAMB(lr=1e-3, weight_decay=0.01,
                               max_grad_norm=1.0, bf16_allgather=True,
                               impl="fused")
    opt_state = opt.init(params)            # fp32 params, same on every rank
    for batch in batches:                   # this rank's part of the batch
        params, opt_state, loss = zero_train_step(params, opt_state, batch,
                                                  cfg, opt)

:func:`mlp_train_step` trains the fused MLP in fp16 under the contrib
``FP16_Optimizer`` (the fp16 master-weight flow of apex's pre-amp API, the
pieces the JAX package's tests compose: ``MLP.apply`` -> MSE loss ->
``scale_loss`` -> gradients of the fp16 leaves -> ``FP16_Optimizer.step``)::

    mlp = MLP([1024, 4096, 4096, 1024], activation="relu", use_pallas=True)
    params = tree_map(lambda p: p.half(), mlp.init(gen))   # fp16 model
    opt = FP16_Optimizer(FusedAdam(lr=1e-3, impl="fused"), params,
                         dynamic_loss_scale=True)
    for batch in batches:                   # {"x": fp16 (B, in), "y": (B, out)}
        params, loss = mlp_train_step(opt, params, batch, mlp)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import amp
from .models.transformer import TransformerConfig, transformer_loss
from .parallel.mesh import group_size
from .utils.pytree import tree_flatten, tree_unflatten

__all__ = ["train_step", "zero_train_step", "mlp_train_step"]


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


def zero_train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                    cfg: TransformerConfig, opt):
    """One ZeRO step: the loss and gradients of ``transformer_loss`` over
    this rank's batch, then ``opt.step`` (a collective over
    ``opt.shard_group``), then the loss averaged over ``opt.shard_group``.
    ``params`` stay fp32 and the activations run in ``cfg.dtype``, with no
    amp, as in the JAX example.  Returns ``(new_params, new_opt_state,
    loss)``, the loss a 0-d fp32 tensor."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = transformer_loss(tree_unflatten(treedef, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    new_params, new_state = opt.step(opt_state,
                                     tree_unflatten(treedef, list(grads)),
                                     params)
    loss = loss.detach().to(torch.float32)
    dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=opt.shard_group)
    return new_params, new_state, loss / group_size(opt.shard_group)


def mlp_train_step(fp16_opt, params, batch: Dict[str, torch.Tensor], mlp):
    """One fp16 MLP step: loss = mean((mlp(x).float() - y)^2), its scaled
    gradients over the model's leaves, then ``fp16_opt.step``, which skips
    the update (and halves a dynamic scale) when a gradient overflowed.
    Returns ``(new_params, loss)``, the loss the unscaled 0-d fp32
    tensor."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    out = mlp(tree_unflatten(treedef, leaves), batch["x"])
    loss = ((out.float() - batch["y"].float()) ** 2).mean()
    grads = torch.autograd.grad(fp16_opt.scale_loss(loss), leaves)
    new_params = fp16_opt.step(tree_unflatten(treedef, list(grads)))
    return new_params, loss.detach()
