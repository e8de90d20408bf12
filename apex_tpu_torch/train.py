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

:func:`simple_ddp_train_step` is the step of the toy data-parallel example
(``examples/simple/distributed/distributed_data_parallel.py``): a 2-layer
MLP under amp O1 (fp16 products from the casts, dynamic loss scale),
``FusedSGD(lr=0.1, momentum=0.9)``, the gradients averaged over a process
group (one process per card, each with its part of the batch)::

    state = amp.initialize(params, FusedSGD(lr=0.1, momentum=0.9),
                           opt_level="O1")
    for _ in range(steps):
        state, loss = simple_ddp_train_step(state, X, Y)

Both run on ``device`` (default ``"cuda"``, raising where CUDA is absent)
and refuse a state whose tensors lie elsewhere; the CPU is used only when
``device="cpu"`` is passed.

:func:`dcgan_train_step` is the step of the dcgan example
(``examples/dcgan/main_amp.py``): the discriminator takes two separately
scaled backward passes (real: loss_id 0, fake: 1) into one
``amp_step_multi``, the generator a third scaler through ``amp_step``::

    cfg = DCGANConfig(dtype=torch.bfloat16)
    params, bn_state = dcgan_init(torch.Generator().manual_seed(0), cfg)
    stateD = amp.initialize(params["disc"],
                            FusedAdam(lr=2e-4, betas=(0.5, 0.999)),
                            opt_level="O4", num_losses=2)
    stateG = amp.initialize(params["gen"],
                            FusedAdam(lr=2e-4, betas=(0.5, 0.999)),
                            opt_level="O4")
    for real, z in batches:                 # NHWC in [-1, 1], (N, latent)
        stateD, stateG, bn_state, errD_real, errD_fake, errG = \
            dcgan_train_step(stateD, stateG, bn_state, real, z, cfg)

The imagenet example's ``--data`` / ``--save`` / ``--resume`` path:
:func:`resnet_sharded_batches` is its ``sharded_npz_loader`` (a seekable
:class:`~apex_tpu_torch.data.ShardedLoader` over ``.npz`` shards of
``images`` / ``labels``), :func:`resnet_checkpoint_entries` the entries it
saves and :func:`resnet_resume` what it does with them on ``--resume``::

    loader = resnet_sharded_batches(data_dir, 128, seed, steps)
    mgr = CheckpointManager(ckpt_dir, keep_last=2)
    for step, (images, labels) in enumerate(loader):
        state, bn_state, loss, acc = resnet_train_step(
            state, bn_state, images, labels, cfg)
    mgr.set_meta({META_DATA_KEY: dict(loader.data_meta(),
                                      cursor=loader.cursor(steps))})
    mgr.save(steps, resnet_checkpoint_entries(state, bn_state, steps))
    ...
    step, payload = mgr.load_latest()       # in a new process
    state, bn_state, start = resnet_resume(payload, state, bn_state)
    loader.seek(start)

:func:`mha_train_step` trains a stack of the attention modules, the stack
of apex's ``perf_test_multihead_attn.py`` (18 layers at 1024 wide, 16
heads, ``--norm-add --biases``), with any of the functional optimizers::

    layers = nn.ModuleList(
        SelfMultiheadAttn(1024, 16, dropout=0.1, bias=True,
                          include_norm_add=True, impl="fast", generator=gen)
        for _ in range(18))
    opt = FusedNovoGrad(impl="fused")
    opt_state = opt.init(mha_params(layers))
    for batch in batches:       # {"query": (T, B, E), "target", masks}
        opt_state, loss = mha_train_step(layers, opt, opt_state, batch,
                                         dropout_rng=gen)

:func:`rnn_lm_train_step` trains the multiplicative-LSTM byte model of
Radford et al. 2017 (NVIDIA's ``sentiment-discovery``): a 64-wide
embedding of 256 bytes, one 4096-unit mLSTM (:mod:`apex_tpu_torch.RNN`)
with weight norm on its four weights
(:mod:`apex_tpu_torch.reparameterization`), a 4096 -> 256 decoder and the
softmax cross-entropy (kernel #7), in fp16 under the legacy
``FP16_Optimizer`` with dynamic loss scaling; truncated backpropagation
through time carries the hidden state from one step to the next::

    params, spec, rnn = rnn_lm_init(gen)           # fp32
    params = tree_map(lambda p: p.half(), params)  # fp16 model
    opt = FP16_Optimizer(FusedAdam(lr=5e-4), params,
                         dynamic_loss_scale=True)
    hx = None
    for tokens, targets in batches:                # (T, B) int64 each
        params, loss, hx = rnn_lm_train_step(
            opt, params, spec, {"tokens": tokens, "targets": targets,
                                "hx": hx}, rnn=rnn)

The imagenet example's ``--auto-resume`` path
(``examples/imagenet/main_amp.py:337-400``): :func:`resnet_guarded_run`
drives :func:`resnet_train_step` under the
:class:`~apex_tpu_torch.resilience.TrainGuard` of
:func:`resnet_auto_resume_guard` (checkpoints every ``save_every`` steps,
a health check every ``print_freq``, scaler-floor escalation after 3
checks), over one of the example's three batch sources
(:func:`resnet_guard_batches`): the seekable ``.npz`` shards (the
manifest records the data cursor), the native prefetch ring over
memmapped ``images.npy`` / ``labels.npy`` (an iterator: a resume
continues it, a needed rollback aborts with ``GuardAbort``), or the
step-addressable synthetic batches (:func:`resnet_synthetic_batch_at`).
It returns the status the example exits with (0 when the run completed,
3 otherwise) for the caller to act on::

    batches = resnet_guard_batches(None, "python", 128, seed, steps)
    guard = resnet_auto_resume_guard(cfg, steps, ckpt_dir=save_dir,
                                     save_every=50, print_freq=10)
    st, bn, report, code = resnet_guarded_run(st, bn, guard, batches,
                                              steps)

:func:`o5_guard_step` is :func:`train_step` as a ``TrainGuard`` step
function; a ``(AmpState, torch.Generator)`` carry draws the step's
dropout from the generator, which the guard saves and restores with the
state.  :func:`flagship_guard_step` is the zero1 flagship step with its
int8 error-feedback residual as a guard step under a process group, with
the manifest layout and the ``state_shards`` an elastic resume needs::

    state, step, layout, shards = flagship_guard_step(
        cfg, ddp_kwargs={"collective_scheme": "int8_blockscale"})
    guard = TrainGuard(step, GuardConfig(ckpt_dir=d, world_size=n,
                                         ckpt_meta={"layout": layout}),
                       state_shards=shards,
                       shard_group=step.weight_update.group)
    state, report = guard.run(state, tokens_at, steps)

2:4 sparsity (ASP) needs no step of its own: ``amp.initialize(params,
asp.wrap_optimizer(FusedLAMB(impl="fused"), masks), "O5")`` then
:func:`train_step` reaches ``SparseOptimizer.step_flat`` through amp's
flat fast path.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import amp, checkpoint
from .RNN import RNNContainer, mLSTM
from .contrib.xentropy import softmax_xentropy_loss
from .data.loader import ArraySource, NativeLoader, SyntheticSource
from .data.sharded import ShardedLoader, open_dataset
from .models.dcgan import (DCGANConfig, discriminator_apply,
                           generator_apply)
from .models.resnet import ResNetConfig, resnet_apply
from .models.transformer import TransformerConfig, transformer_loss
from .optimizers import FusedAdam
from .parallel.distributed import DistributedDataParallel
from .parallel.mesh import group_size, resolve_group
from .reparameterization import apply_weight_norm, compute_weights
from .telemetry import trace as _trace
from .utils.device import resolve_device
from .utils.pytree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

__all__ = ["train_step", "zero_train_step", "build_flagship_step",
           "flagship_guard_step", "mlp_train_step",
           "resnet_train_step", "resnet_eval_step", "simple_ddp_train_step",
           "bce_logits", "dcgan_train_step", "resnet_checkpoint_entries",
           "resnet_resume", "resnet_checkpoint_from_jax",
           "resnet_sharded_batches", "resnet_synthetic_batch_at",
           "resnet_native_batches", "resnet_guard_batches",
           "resnet_auto_resume_guard", "resnet_guarded_run",
           "o5_guard_step",
           "mha_params", "mha_apply",
           "mha_train_step", "rnn_lm_init", "rnn_lm_loss",
           "rnn_lm_train_step"]


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
    with _trace.span("train.forward"):
        loss = transformer_loss(params, batch, cfg, dropout_rng=dropout_rng,
                                smoothing=smoothing)
        scaled = amp.scale_loss(loss, amp_state)
    with _trace.span("train.backward"):
        grads = torch.autograd.grad(scaled, leaves)
    new_state = amp.amp_step(amp_state, tree_unflatten(treedef, list(grads)))
    return new_state, loss.detach()


def zero_train_step(params, opt_state, batch: Dict[str, torch.Tensor],
                    cfg: TransformerConfig, opt, *, residual=None):
    """One ZeRO step: the loss and gradients of ``transformer_loss`` over
    this rank's batch, then ``opt.step`` (a collective over
    ``opt.shard_group``), then the loss averaged over ``opt.shard_group``.
    ``params`` stay fp32 and the activations run in ``cfg.dtype``, with no
    amp, as in the JAX example.  Returns ``(new_params, new_opt_state,
    loss)``, the loss a 0-d fp32 tensor; with ``residual`` (the int8
    error-feedback state, ``opt.init_residual(params)``) ``(new_params,
    new_opt_state, loss, new_residual)``."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = transformer_loss(tree_unflatten(treedef, leaves), batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    out = opt.step(opt_state, tree_unflatten(treedef, list(grads)), params,
                   **({} if residual is None else {"residual": residual}))
    loss = mean_loss(loss, opt.shard_group)
    if residual is None:
        return out[0], out[1], loss
    return out[0], out[1], loss, out[2]


def mean_loss(loss: torch.Tensor, group) -> torch.Tensor:
    """``loss`` detached, in fp32 and averaged over ``group`` (one
    all-reduce), which resolves as a collective's does
    (:func:`~apex_tpu_torch.parallel.mesh.resolve_group`: ``None`` is the
    default group once torch.distributed is up, else no group and the
    loss as it is)."""
    loss = loss.detach().to(torch.float32).clone()
    group = resolve_group(group)
    if group is None:
        return loss
    dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
    return loss / group_size(group)


#: flat elements a chunk of :func:`flat_update` covers
UPDATE_CHUNK = 1 << 26


def flat_update(opt, state, params, held, finite_group=None):
    """The fused-flat update with the amp overflow select: the (already
    reduced) gradient tree ``held[0]`` flattened and stepped through
    ``opt.step_flat``; a step whose gradients are not all finite leaves
    the state as it was.  Returns ``(new_params, new_state)``.
    ``finite_group``: the flag is a MIN over it, for ranks that hold
    different leaves (tensor-parallel shards) and must skip together.

    The tree comes in a one-item list that this function empties, and no
    full-size buffer outlives its last use, so at billions of parameters a
    step holds one gradient-sized buffer at a time beside the two states.
    ``step_flat`` runs over chunks of ``UPDATE_CHUNK`` elements of the
    flat buffers, each chunk's result selected into the new buffers, so
    its temporaries stay chunk-sized; the math is elementwise, so the bits
    are those of one step over the whole buffers."""
    fl = opt.flattener_for(params)
    flat = fl.flatten(held.pop())
    n = flat.numel()
    ok = torch.isfinite(flat).all()
    if finite_group is not None:
        flag = ok.to(torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=finite_group)
        ok = flag.bool()
    is_flat = [isinstance(l, torch.Tensor) and l.dim() == 1
               and l.shape[0] == n for l in state]
    out = [torch.empty_like(l) if f else None
           for l, f in zip(state, is_flat)]
    for i in range(0, n, UPDATE_CHUNK):
        j = min(i + UPDATE_CHUNK, n)
        part = type(state)(*[l[i:j] if f else l
                             for l, f in zip(state, is_flat)])
        new = opt.step_flat(part, flat[i:j])
        for k, f in enumerate(is_flat):
            if f:
                torch.where(ok, new[k], part[k], out=out[k][i:j])
            elif i == 0:
                out[k] = torch.where(ok, new[k], state[k])
        del new, part
    del flat
    state = type(state)(*out)
    return fl.unflatten(state.master, like=params), state


def build_flagship_step(cfg: TransformerConfig, *, ddp_kwargs=None,
                        params=None, seed: int = 0, lr: float = 1e-2,
                        device=None):
    """The flagship transformer's DDP + ``FusedAdam(impl="fused")`` step,
    the counterpart of the JAX package's ``parallel.plan.
    build_flagship_step``: ``(carry0, step)`` with ``step(carry, tokens) ->
    (carry, loss)``, ``tokens`` this rank's ``(batch, seq)`` int64 (the
    targets are the tokens), the loss averaged over the group.

    The knobs come through ``ddp_kwargs`` (``DistributedDataParallel``'s)
    or the environment (``APEX_TPU_OVERLAP``, ``APEX_TPU_UPDATE_SHARDING``,
    ``APEX_TPU_COLLECTIVES``), resolved when the step is built.  With
    ``update_sharding`` off the gradients come from
    :meth:`~apex_tpu_torch.parallel.DistributedDataParallel.grad` (reduced
    during the backward under ``overlap="bucketed"``), then ``step_flat``
    and the overflow select; with ``"zero1"`` the local gradients go
    through :meth:`~apex_tpu_torch.parallel.weight_update.ShardedUpdate.
    step`.  ``params`` (default ``transformer_init`` from ``seed``) are the
    starting weights; ``lr`` defaults to the JAX step's 1e-2."""
    return _build_flagship_step(cfg, ddp_kwargs=ddp_kwargs, params=params,
                                seed=seed, lr=lr, device=device)


def _build_flagship_step(cfg: TransformerConfig, *, ddp_kwargs=None,
                         params=None, seed: int = 0, lr: float = 1e-2,
                         device=None, error_feedback: bool = False):
    """:func:`build_flagship_step`; ``error_feedback`` (zero1 only, for
    :func:`flagship_guard_step`) threads the reduce-scatter's int8
    error-feedback residual through the carry, ``(params, state,
    residual)``, as the JAX elastic harness's step does."""
    from .models.transformer import transformer_init
    dev = resolve_device(device)
    params0 = params if params is not None else transformer_init(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = FusedAdam(lr=lr, impl="fused")
    ddp = DistributedDataParallel(device=dev, **(ddp_kwargs or {}))
    su = ddp.weight_update(opt)
    group = resolve_group(ddp.axis_name)
    state0 = opt.init(params0) if su is None else su.init(params0)
    carry0 = (params0, state0)
    if error_feedback:
        if su is None:
            raise ValueError("error feedback rides the zero1 reduce-scatter:"
                             " pass ddp_kwargs={'update_sharding': 'zero1'}")
        carry0 += (su.init_residual(params0),)

    def step(carry, tokens):
        params, state, *res = carry
        leaves, treedef = _grad_leaves(params)
        loss = transformer_loss(tree_unflatten(treedef, leaves),
                                {"tokens": tokens, "targets": tokens}, cfg)
        if su is None:
            held = [ddp.grad(loss, tree_unflatten(treedef, leaves))]
            carry = flat_update(opt, state, params, held)
        else:
            grads = torch.autograd.grad(loss, leaves)
            carry = su.step(state, tree_unflatten(treedef, list(grads)),
                            params, residual=res[0] if res else None)
        return tuple(carry), mean_loss(loss, group)

    step.ddp = ddp
    step.weight_update = su
    return carry0, step


def flagship_guard_step(cfg: TransformerConfig, *, ddp_kwargs=None,
                        params=None, seed: int = 0, lr: float = 1e-2,
                        device=None):
    """The zero1 flagship step with its int8 error-feedback residual, ready
    for :class:`~apex_tpu_torch.resilience.TrainGuard` under a process
    group (the JAX elastic harness's step): ``(state0, step, layout,
    state_shards)``.  ``state`` is ``(params, opt_state, residual)``;
    ``step(state, tokens) -> (state, loss)``; ``layout`` is the manifest's
    ``ShardedUpdate.layout_meta`` at the group's world; ``state_shards``
    names the flat-shard fields and the residual for the guard's
    ``state_shards=``, sharded over ``step.weight_update.group`` (the
    guard's ``shard_group=``).  ``ddp_kwargs`` default to ``update_sharding=
    "zero1"`` with the collective scheme from the environment."""
    kw = dict(ddp_kwargs or {})
    kw.setdefault("update_sharding", "zero1")
    carry0, step = _build_flagship_step(cfg, ddp_kwargs=kw, params=params,
                                        seed=seed, lr=lr, device=device,
                                        error_feedback=True)
    su = step.weight_update
    world = group_size(su.group)
    shards = (None, su.state_pspecs(carry0[0], world), "stack")
    return carry0, step, su.layout_meta(carry0[0], world), shards


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
    scaled = amp.scale_loss(loss, amp_state)
    if ddp is None:
        grads = tree_unflatten(treedef,
                               list(torch.autograd.grad(scaled, leaves)))
    else:
        # reduced during the backward when ddp's overlap is "bucketed"
        grads = ddp.grad(scaled, tree_unflatten(treedef, leaves))
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


def resnet_checkpoint_entries(amp_state: amp.AmpState, bn_state,
                              step: int) -> dict:
    """The entries the imagenet example saves (``checkpoint.save(path,
    **entries)``): ``step``, ``model``, ``masters``, ``opt``, ``amp``
    (``amp.state_dict``) and ``bn``."""
    return dict(step=int(step), model=amp_state.model_params,
                masters=amp_state.master_params, opt=amp_state.opt_state,
                amp=amp.state_dict(amp_state), bn=bn_state)


def resnet_resume(payload, amp_state: amp.AmpState, bn_state):
    """The example's ``--resume``: the model, the masters (where the
    payload has them), the optimizer state and the batch-norm statistics
    of ``payload`` (from ``checkpoint.load``) restored like
    ``amp_state``'s and ``bn_state``'s tensors, then its loss scalers.
    Returns ``(amp_state, bn_state, start_step)``."""
    masters = payload.get("masters")
    st = amp_state._replace(
        model_params=checkpoint.restore_like(amp_state.model_params,
                                             payload["model"]),
        master_params=(None if masters is None else checkpoint.restore_like(
            amp_state.master_params, masters)),
        opt_state=checkpoint.restore_like(amp_state.opt_state,
                                          payload["opt"]))
    st = amp.load_state_dict(st, payload["amp"])
    return (st, checkpoint.restore_like(bn_state, payload["bn"]),
            int(payload["step"]))


def resnet_checkpoint_from_jax(payload) -> dict:
    """A checkpoint the JAX imagenet example wrote, with every HWIO kernel
    of its model, masters and optimizer moments (the 4-d leaves) as OIHW,
    the port's layout, ready for :func:`resnet_resume`."""
    def oihw(a):
        return np.transpose(a, (3, 2, 0, 1)) if np.ndim(a) == 4 else a
    return {k: tree_map(oihw, v) if k in ("model", "masters", "opt") else v
            for k, v in payload.items()}


def resnet_sharded_batches(directory: str, batch: int, seed: int,
                           steps: int, device=None) -> ShardedLoader:
    """The example's ``sharded_npz_loader``: a :class:`ShardedLoader` over
    ``directory``'s ``.npz`` shards (``images`` NHWC, ``labels``; the
    index written when absent) of ``steps`` global batches of ``batch``.
    Its transform gives uint8 images as fp32 / 255 (other images as fp32)
    and int32 labels, computed in numpy on the fill thread, both on
    ``device`` (default ``"cuda"``)."""
    dev = resolve_device(device)

    def tf(b, step):
        x = b["images"]
        x = (x.astype(np.float32) / 255.0 if x.dtype == np.uint8
             else x.astype(np.float32))
        y = b["labels"].astype(np.int32)
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    return ShardedLoader(open_dataset(directory), global_batch=batch,
                         seed=seed, num_steps=steps, transform=tf)


#: the synthetic pool's learnable classes and its seed (the example's
#: ``_SYN_CLASSES`` and prototype seed)
SYN_CLASSES, SYN_POOL_SEED = 64, 1234
_SYN_POOLS: Dict[int, np.ndarray] = {}


def _syn_protos(hw: int) -> np.ndarray:
    """The example's prototype pool: one uniform image a class, seeded
    apart from the batches (built once a process and size)."""
    if hw not in _SYN_POOLS:
        _SYN_POOLS[hw] = np.random.RandomState(SYN_POOL_SEED).rand(
            SYN_CLASSES, hw, hw, 3).astype(np.float32)
    return _SYN_POOLS[hw]


def resnet_synthetic_batch_at(batch: int, seed: int, step: int, *,
                              hw: int = 224, device=None):
    """The example's ``synthetic_batch_at``: the batch of global ``step``,
    seeded by (seed, step), so a resume or a rollback replays it exactly.
    Prototypes of the pool sampled by label plus N(0, 0.08^2) noise, made
    in numpy (the example's numbers) and copied to ``device`` (default
    ``"cuda"``): NHWC fp32 images and int32 labels."""
    dev = resolve_device(device)
    rng = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, step])))
    labels = rng.integers(0, SYN_CLASSES, size=(batch,))
    images = _syn_protos(hw)[labels] + 0.08 * rng.standard_normal(
        (batch, hw, hw, 3), dtype=np.float32)
    return (torch.from_numpy(images).to(dev),
            torch.from_numpy(labels.astype(np.int32)).to(dev))


def resnet_native_batches(data: Optional[str], batch: int, seed: int,
                          steps: int, *, hw: int = 224, device=None,
                          wait_timeout: Optional[float] = None):
    """The example's ``native_batches``: an iterator of (images, labels)
    from the native prefetch ring, over ``data``'s memmapped
    ``images.npy`` (fp32 NHWC) and ``labels.npy`` (int32), or over the
    ring's uniform synthetic source without ``data``.  On the card the
    ring hands out pinned tensors, copied with ``non_blocking=True``."""
    dev = resolve_device(device)
    if data:
        img = os.path.join(data, "images.npy")
        lab = os.path.join(data, "labels.npy")
        if not (os.path.exists(img) and os.path.exists(lab)):
            raise FileNotFoundError(
                f"the native loader with a data directory needs {img} and "
                f"{lab} (fp32 NHWC and int32, memmapped, not loaded)")
        src = ArraySource(data=np.load(img, mmap_mode="r"),
                          labels=np.load(lab, mmap_mode="r"))
    else:
        src = SyntheticSource(shape=(hw, hw, 3), n_classes=1000)
    pinned = dev.type == "cuda"
    loader = NativeLoader(src, batch_size=batch, steps=steps, seed=seed,
                          device_put=pinned, wait_timeout=wait_timeout)
    for x, y in loader:
        if not pinned:
            x, y = torch.from_numpy(x), torch.from_numpy(y)
        yield (x.to(dev, non_blocking=True), y.to(dev, non_blocking=True))


def resnet_guard_batches(data: Optional[str], loader: str, batch: int,
                         seed: int, steps: int, *, hw: int = 224,
                         device=None, wait_timeout: Optional[float] = None):
    """The example's ``--auto-resume`` batch source: a directory of
    ``.npz`` shards -> :func:`resnet_sharded_batches` (seekable; the guard
    records its cursor); another ``data`` directory or ``loader ==
    "native"`` -> :func:`resnet_native_batches` (an iterator); else the
    step-addressable :func:`resnet_synthetic_batch_at` as a callable."""
    if data and any(f.endswith(".npz") for f in os.listdir(data)):
        return resnet_sharded_batches(data, batch, seed, steps,
                                      device=device)
    if data or loader == "native":
        return resnet_native_batches(data, batch, seed, steps, hw=hw,
                                     device=device,
                                     wait_timeout=wait_timeout)
    return lambda step: resnet_synthetic_batch_at(batch, seed, step, hw=hw,
                                                  device=device)


def resnet_auto_resume_guard(cfg: ResNetConfig, total_steps: int, *,
                             ckpt_dir: str, save_every: int = 0,
                             print_freq: int = 10, plan=None, registry=None,
                             ddp=None,
                             log: Optional[Callable[[str], None]] = print):
    """The example's ``--auto-resume`` guard: a ``TrainGuard`` over
    :func:`resnet_train_step` on an ``(amp_state, bn_state)`` carry, with
    ``GuardConfig(ckpt_dir, save_every_steps=save_every, check_every=max(1,
    print_freq), floor_patience=3)`` and an ``on_check`` that gives ``log``
    the example's line (speed and loss); None logs nothing."""
    from .resilience import GuardConfig, TrainGuard
    if not ckpt_dir:
        raise ValueError("the auto-resume run needs a checkpoint directory")
    seen = {"batch": 0, "t": time.perf_counter()}

    def gstep(carry, batch):
        st, bn = carry
        seen["batch"] = batch[1].shape[0]     # host metadata, no read
        st, bn, loss, acc = resnet_train_step(st, bn, *batch, cfg, ddp=ddp)
        return (st, bn), loss, acc

    def on_check(step, losses):
        now = time.perf_counter()
        ips = len(losses) * seen["batch"] / max(now - seen["t"], 1e-9)
        seen["t"] = now
        if log is not None:
            log(f"Step [{step}/{total_steps}]  Speed {ips:.1f} img/s  "
                f"Loss {losses[-1]:.4f}")

    return TrainGuard(gstep, GuardConfig(
        ckpt_dir=ckpt_dir, save_every_steps=save_every,
        check_every=max(1, print_freq), floor_patience=3),
        plan=plan, registry=registry, on_check=on_check)


def resnet_guarded_run(amp_state: amp.AmpState, bn_state, guard, batches,
                       total_steps: int, *,
                       log: Optional[Callable[[str], None]] = print):
    """The example's ``--auto-resume`` run: ``guard`` (from
    :func:`resnet_auto_resume_guard`) over ``batches`` (from
    :func:`resnet_guard_batches`), resuming from its checkpoint
    directory's newest checkpoint; ``log`` gets "resumed from" and the
    status line.  Returns ``(amp_state, bn_state, report, status)``:
    status 0 when the run completed, 3 otherwise (preempted: rerun to
    resume), the example's exit code, for the caller to act on."""
    (amp_state, bn_state), rep = guard.run((amp_state, bn_state), batches,
                                           total_steps)
    if log is not None:
        if rep.resumed_from is not None:
            log(f"=> guard resumed from step {rep.resumed_from}")
        log(f"=> guard: {rep.status} at step {rep.final_step}/{total_steps}"
            f"  (rollbacks {rep.rollbacks}, faults {rep.faults_injected}, "
            f"checkpoints {rep.checkpoints})")
    return amp_state, bn_state, rep, 0 if rep.status == "completed" else 3


def o5_guard_step(cfg: TransformerConfig, *, smoothing: float = 0.0):
    """:func:`train_step` as a ``TrainGuard`` step function: ``state`` an
    ``AmpState`` -> ``(state, loss)``, or an ``(AmpState,
    torch.Generator)`` carry whose generator draws the step's dropout ->
    ``((state, generator), loss)``."""
    def step(state, batch):
        if isinstance(state, tuple):
            st, gen = state
            st, loss = train_step(st, batch, cfg, dropout_rng=gen,
                                  smoothing=smoothing)
            return (st, gen), loss
        return train_step(state, batch, cfg, smoothing=smoothing)
    return step


def _grad_leaves(tree):
    """(leaves that require grad, treedef) of a parameter tree."""
    leaves, treedef = tree_flatten(tree)
    return [p.detach().requires_grad_(True) for p in leaves], treedef


def _check_device(device, *trees):
    """Resolve ``device`` (default ``"cuda"``) and refuse a tensor of
    ``trees`` on another device type."""
    dev = resolve_device(device)
    for t in trees:
        for leaf in tree_leaves(t):
            if isinstance(leaf, torch.Tensor) and leaf.device.type != dev.type:
                raise RuntimeError(
                    f"a tensor on {leaf.device} reaches a step run on {dev}; "
                    "pass device= the device the model lives on")


def simple_ddp_train_step(amp_state: amp.AmpState, X, Y, *, group=None,
                          device=None):
    """One step of the toy MLP (``fc1`` / ``fc2`` ``{w, b}``):
    ``relu(X @ w1 + b1) @ w2 + b2`` through ``torch.matmul`` (cast by O1's
    casts), the MSE in fp32, its scaled gradients averaged over ``group``
    (None: the default group when torch.distributed is initialised, else
    none) and ``amp.amp_step``.  ``X`` / ``Y`` are this rank's rows.
    Returns ``(new_amp_state, loss)``, the loss the unscaled 0-d fp32 mean
    over the group's ranks."""
    _check_device(device, amp_state.model_params, X, Y)
    leaves, treedef = _grad_leaves(amp_state.model_params)
    p = tree_unflatten(treedef, leaves)
    h = torch.relu(torch.matmul(amp_state.cast_input(X), p["fc1"]["w"])
                   + p["fc1"]["b"])
    pred = torch.matmul(h, p["fc2"]["w"]) + p["fc2"]["b"]
    loss = torch.mean((pred.to(torch.float32) - Y) ** 2)
    # averaged over the group (during the backward under
    # APEX_TPU_OVERLAP=bucketed), as allreduce_tree averages it
    ddp = DistributedDataParallel(axis_name=group,
                                  device=resolve_device(device))
    grads = ddp.grad(amp.scale_loss(loss, amp_state), p)
    loss = loss.detach()
    g = resolve_group(group)
    if g is not None:
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=g)
        loss = loss / group_size(g)
    return amp.amp_step(amp_state, grads), loss


def bce_logits(logits, target):
    """Binary cross-entropy with logits, through the namespace calls of
    the JAX example's (``maximum``, ``log1p``, ``exp``, ``abs``, ``mean``),
    so the fp32 list applies to the same calls."""
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * target
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def dcgan_train_step(stateD: amp.AmpState, stateG: amp.AmpState, bn_state,
                     real, z, cfg: DCGANConfig, *, device=None):
    """One DCGAN step: D on real (loss_id 0) and detached fake images
    (loss_id 1) into one ``amp_step_multi``, then G through its own scaler
    against the updated D.  The batch-norm statistics chain through the
    passes as the JAX step threads them: the fake images' generator pass
    (bn1), D on real (bn_r), D on fake (bn2), G's generator pass (bn3)
    and D on G's images (bn4).  Returns ``(stateD, stateG, bn4,
    errD_real, errD_fake, errG)``, the losses unscaled 0-d fp32 (the JAX
    step returns all but ``errD_fake``)."""
    _check_device(device, stateD.model_params, stateG.model_params,
                  bn_state, real, z)
    params = {"disc": stateD.model_params, "gen": stateG.model_params}
    with torch.no_grad():
        fake, bn1 = generator_apply(params, bn_state, z, cfg)

    d_leaves, d_def = _grad_leaves(stateD.model_params)
    logits, bn_r = discriminator_apply(
        {"disc": tree_unflatten(d_def, d_leaves), "gen": None}, bn1, real,
        cfg)
    err_real = bce_logits(logits, 1.0)
    gr = torch.autograd.grad(amp.scale_loss(err_real, stateD, loss_id=0),
                             d_leaves)

    d_leaves, _ = _grad_leaves(stateD.model_params)
    logits, bn2 = discriminator_apply(
        {"disc": tree_unflatten(d_def, d_leaves), "gen": None}, bn_r, fake,
        cfg)
    err_fake = bce_logits(logits, 0.0)
    gf = torch.autograd.grad(amp.scale_loss(err_fake, stateD, loss_id=1),
                             d_leaves)
    new_stateD = amp.amp_step_multi(
        stateD, [(tree_unflatten(d_def, list(gr)), 0),
                 (tree_unflatten(d_def, list(gf)), 1)])

    g_leaves, g_def = _grad_leaves(stateG.model_params)
    p = {"disc": new_stateD.model_params,
         "gen": tree_unflatten(g_def, g_leaves)}
    imgs, bn3 = generator_apply(p, bn2, z, cfg)
    logits, bn4 = discriminator_apply(p, bn3, imgs, cfg)
    err_g = bce_logits(logits, 1.0)
    gg = torch.autograd.grad(amp.scale_loss(err_g, stateG, loss_id=0),
                             g_leaves)
    new_stateG = amp.amp_step(stateG, tree_unflatten(g_def, list(gg)))
    return (new_stateD, new_stateG, bn4, err_real.detach(),
            err_fake.detach(), err_g.detach())


def mha_params(model) -> Dict[str, torch.Tensor]:
    """An attention stack's parameters as the optimizers' tree: each
    ``named_parameters()`` name -> the detached tensor."""
    return {n: p.detach() for n, p in model.named_parameters()}


def mha_apply(model, batch: Dict[str, torch.Tensor], *, dropout_rng=None):
    """An attention stack's training forward: ``model`` (an
    ``nn.ModuleList`` of ``SelfMultiheadAttn`` or of
    ``EncdecMultiheadAttn``) applied layer by layer to ``batch["query"]``
    (T, B, E), each layer attending to ``batch["key"]`` (S, B, E) where the
    batch has one (the encdec form), every layer with the batch's optional
    ``key_padding_mask`` / ``attn_mask`` and ``dropout_rng`` (a
    ``torch.Generator`` draws anew for each layer).  Returns the last
    layer's output."""
    masks = dict(key_padding_mask=batch.get("key_padding_mask"),
                 attn_mask=batch.get("attn_mask"))
    extra = (batch["key"],) if "key" in batch else ()
    x = batch["query"]
    for layer in model:
        x, _ = layer(x, *extra, is_training=True, dropout_rng=dropout_rng,
                     **masks)
    return x


def mha_train_step(model, opt, opt_state, batch: Dict[str, torch.Tensor],
                   *, dropout_rng=None, mark=None):
    """One step of an attention stack: :func:`mha_apply`, the loss
    mean((out - ``batch["target"]``)^2) in fp32, its gradients over the
    model's parameters, ``opt.step(opt_state, grads, params)`` (any of the
    port's functional optimizers, its state from
    ``opt.init(mha_params(model))``) and the new parameters copied into
    the model.  ``mark``, if given, is called with no argument after the
    loss and after the gradients (a timer's split points).  Returns
    ``(new_opt_state, loss)``, the loss a 0-d fp32 tensor."""
    names, params = zip(*model.named_parameters())
    x = mha_apply(model, batch, dropout_rng=dropout_rng)
    loss = ((x.float() - batch["target"].float()) ** 2).mean()
    if mark is not None:
        mark()
    grads = torch.autograd.grad(loss, params)
    if mark is not None:
        mark()
    new_params, new_state = opt.step(
        opt_state, dict(zip(names, grads)),
        {n: p.detach() for n, p in zip(names, params)})
    with torch.no_grad():
        for n, p in zip(names, params):
            p.copy_(new_params[n])
    return new_state, loss.detach()


#: the mLSTM's weight-normed leaves (the reference's sentiment-discovery
#: model normalises these four, over dim 0)
RNN_LM_WN_NAMES = ("w_ih", "w_hh", "w_mih", "w_mhh")


def rnn_lm_init(gen: torch.Generator, *, vocab: int = 256, emb: int = 64,
                hidden: int = 4096, device=None):
    """The byte mLSTM's fp32 parameters, drawn on the CPU from ``gen`` and
    put on ``device`` (default ``"cuda"``): ``{"embed": (vocab, emb),
    "rnn": {"layer0": the mLSTM's leaves, w_ih / w_hh / w_mih / w_mhh as
    {weight_g, weight_v}}, "dec": {"w": (hidden, vocab), "b": (vocab,)}}``.
    Returns ``(params, spec, rnn)``: the weight-norm spec for
    :func:`~apex_tpu_torch.reparameterization.compute_weights` and the
    :class:`~apex_tpu_torch.RNN.RNNContainer`."""
    dev = resolve_device(device)
    rnn = mLSTM(emb, hidden, 1)
    std = 1.0 / hidden ** 0.5
    params = {
        "embed": torch.randn(vocab, emb, generator=gen).to(dev),
        "rnn": rnn.init(gen, device=dev),
        "dec": {"w": (torch.rand(hidden, vocab, generator=gen) * (2 * std)
                      - std).to(dev),
                "b": torch.zeros(vocab, device=dev)},
    }
    params, spec = apply_weight_norm(params, names=RNN_LM_WN_NAMES, dim=0)
    return params, spec, rnn


def rnn_lm_loss(params, spec, batch: Dict[str, torch.Tensor],
                rnn: RNNContainer):
    """The byte model's forward: the weights from their (g, v) pairs, the
    embedding of ``batch["tokens"]`` (T, B), the mLSTM from
    ``batch.get("hx")`` (zeros where absent), the decoder's (T * B, vocab)
    logits and their mean cross-entropy against ``batch["targets"]``
    (kernel #7, fp32 out of fp16 logits).  Returns ``(loss, final hidden
    list)``."""
    w = compute_weights(params, spec)
    tokens = batch["tokens"]
    x = w["embed"][tokens]
    out, finals = rnn.apply(w["rnn"], x, batch.get("hx"))
    logits = out.reshape(-1, out.shape[-1]) @ w["dec"]["w"] + w["dec"]["b"]
    # every byte is a label: no padding index among 0..vocab-1
    losses = softmax_xentropy_loss(logits, batch["targets"].reshape(-1),
                                   padding_idx=-1, half_to_float=True)
    return losses.mean(), finals


def rnn_lm_train_step(fp16_opt, params, spec, batch: Dict[str, torch.Tensor],
                      *, rnn: RNNContainer):
    """One truncated-BPTT step of the byte model under ``fp16_opt`` (an
    ``FP16_Optimizer`` over ``params``, the fp16 model tree): the scaled
    loss's gradients over every leaf (g and v included), then
    ``fp16_opt.step``, which updates the fp32 masters or skips the step
    when a gradient overflowed.  Returns ``(new_params, loss, hidden)``:
    the loss the unscaled 0-d fp32 tensor, the final hidden state detached
    for the next step's ``batch["hx"]``."""
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss, finals = rnn_lm_loss(tree_unflatten(treedef, leaves), spec, batch,
                               rnn)
    grads = torch.autograd.grad(fp16_opt.scale_loss(loss), leaves)
    new_params = fp16_opt.step(tree_unflatten(treedef, list(grads)))
    hidden = [tuple(h.detach() for h in hs) for hs in finals]
    return new_params, loss.detach(), hidden
