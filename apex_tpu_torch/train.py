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

:func:`resnet_train_step` is the step of the JAX imagenet example
(``examples/imagenet/main_amp.py`` ``train_step``): ResNet-50 under amp O2
(fp16 weights with fp32 batch norm, bf16 activations) and ``FusedAdam``;
with ``ddp`` (``--distributed --sync-bn``, one process per card) the
gradients are averaged over ``ddp``'s group and every batch norm syncs its
statistics over it::

    cfg = resnet50_config(dtype=torch.bfloat16)
    params, bn_state = resnet_init(torch.Generator().manual_seed(0), cfg)
    state = amp.initialize(params, FusedAdam(lr=1e-3), opt_level="O2")
    for images, labels in batches:          # NHWC fp32, int64
        state, bn_state, loss, acc = resnet_train_step(
            state, bn_state, images, labels, cfg)
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from . import amp
from .models.resnet import ResNetConfig, resnet_apply
from .models.transformer import TransformerConfig, transformer_loss
from .parallel.mesh import group_size
from .utils.pytree import tree_flatten, tree_unflatten

__all__ = ["train_step", "zero_train_step", "mlp_train_step",
           "resnet_train_step", "resnet_eval_step"]


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


def resnet_train_step(amp_state: amp.AmpState, bn_state, images, labels,
                      cfg: ResNetConfig, *, ddp=None):
    """One imagenet step: the fp32 ``log_softmax`` of the logits, the mean
    negative log-likelihood of ``labels``, ``amp.scale_loss``, its
    gradients over the model's leaves, ``ddp.allreduce_grads`` when given
    (the batch norms then sync over ``ddp``'s group) and ``amp.amp_step``.
    Returns ``(new_amp_state, new_bn_state, loss, acc)``, the loss
    (unscaled) and the top-1 accuracy of this rank's batch as 0-d fp32
    tensors."""
    leaves, treedef = tree_flatten(amp_state.model_params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    logits, new_bn = resnet_apply(
        tree_unflatten(treedef, leaves), bn_state, images, cfg, train=True,
        axis_name=None if ddp is None else ddp.axis_name)
    lp = torch.log_softmax(logits.float(), dim=-1)
    loss = -lp.gather(1, labels.long()[:, None]).mean()
    acc = (logits.argmax(dim=1) == labels).float().mean()
    grads = torch.autograd.grad(amp.scale_loss(loss, amp_state), leaves)
    grads = tree_unflatten(treedef, list(grads))
    if ddp is not None:
        grads = ddp.allreduce_grads(grads)
    return (amp.amp_step(amp_state, grads), new_bn, loss.detach(),
            acc.detach())


@torch.no_grad()
def resnet_eval_step(amp_state: amp.AmpState, bn_state, images, labels,
                     cfg: ResNetConfig):
    """The example's ``validate`` step: batch norm on its running
    statistics; returns the (top-1, top-5) accuracy of the batch as 0-d
    fp32 tensors."""
    logits, _ = resnet_apply(amp_state.model_params, bn_state, images, cfg,
                             train=False)
    labels = labels.long()
    top1 = (logits.argmax(dim=1) == labels).float().mean()
    top5 = (logits.topk(5, dim=1).indices == labels[:, None]).any(
        dim=1).float().mean()
    return top1, top5
