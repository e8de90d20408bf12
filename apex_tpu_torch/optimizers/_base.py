"""Shared machinery for the fused optimizers.

Counterpart of ``apex_tpu/optimizers/_base.py``.  An optimizer is an
algorithm object (hyperparameters only) with ``init(params) -> state`` and
``step(state, grads, params) -> (new_params, new_state)``; states are named
tuples of tensors and every step returns new tensors (nothing is updated in
place), so a skipped step can keep the old state.  Two implementations:

- ``impl="xla"``: per-leaf updates over the parameter tree;
- ``impl="fused"``: the flat engine — optimizer state and master params
  live in one flat fp32 buffer per field (:class:`~apex_tpu_torch.
  multi_tensor_apply.TreeFlattener`), and ``step_flat(state, flat_grads)``
  updates them with no per-step packing.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..multi_tensor_apply.flattener import TreeFlattener
from ..utils.pytree import tree_flatten, tree_leaves, tree_unflatten

__all__ = ["FusedOptimizer", "global_l2norm", "resolve",
           "resolve_state_dtype", "tree_zeros_f32"]


def global_l2norm(tree) -> torch.Tensor:
    """Global norm over a tree's leaves (fp32), the plain per-leaf form."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(l.float().square().sum() for l in leaves))


def tree_zeros_f32(params):
    """fp32 zeros shaped like each leaf, on its device."""
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [torch.zeros(l.shape, dtype=torch.float32,
                                                device=l.device)
                                    for l in leaves])


def resolve(value, count):
    """Hyperparams may be schedules: callables of the step count."""
    if callable(value):
        return value(count)
    return value


def lr_tensor(lr, device) -> torch.Tensor:
    """A learning rate as a 0-d fp32 tensor on ``device``.  A Python number
    is written by a fill on the device (``torch.full``), not copied from
    the host: a host-to-device copy of pageable memory synchronizes with
    the stream, which the JAX step (the rate a constant of the jitted
    program) never does."""
    if isinstance(lr, torch.Tensor):
        return lr.to(device=device, dtype=torch.float32)
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def resolve_state_dtype(state_dtype) -> torch.dtype:
    """Validate and default the moment-storage dtype."""
    if state_dtype is None:
        return torch.float32
    if not isinstance(state_dtype, torch.dtype) \
            or not state_dtype.is_floating_point:
        # an int dtype would truncate every stored moment toward zero
        raise ValueError(f"state_dtype must be a float dtype, got "
                         f"{state_dtype}")
    return state_dtype


class FusedOptimizer:
    """Base: impl selection and the flattener of the fused path.

    ``state_dtype`` (fused impl only): storage dtype of the m/v buffers.
    The arithmetic stays fp32 (moments are upcast at read, cast back at
    store); master params always stay fp32."""

    #: the flat update is strictly per element, so a contiguous slice of
    #: the flat buffers updates as the whole does and weight-update
    #: sharding runs ``step_flat`` on each rank's slice unchanged;
    #: optimizers with per-tensor reductions in their flat math (LAMB's
    #: trust ratios, NovoGrad's second moment) set it False and override
    #: :meth:`step_flat_shard`
    elementwise_flat_update = True

    def __init__(self, lr, weight_decay=0.0, impl="xla", state_dtype=None):
        if impl not in ("xla", "fused"):
            raise ValueError(f"impl must be 'xla' or 'fused', got {impl!r}")
        if state_dtype is not None and impl != "fused":
            raise ValueError("state_dtype is a flat-engine (impl='fused') "
                             "knob; the xla impl keeps fp32 moments")
        self.lr = lr
        self.weight_decay = weight_decay
        self.impl = impl
        self.state_dtype = resolve_state_dtype(state_dtype)
        self._flattener: Optional[TreeFlattener] = None
        self._flattener_key = None

    def _store_moment(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.state_dtype)

    def flattener_for(self, params, chunk=None) -> TreeFlattener:
        """Packing plan for ``params`` (cached per structure, shapes and
        dtypes).  ``chunk`` pins the padding quantum (weight-update
        sharding passes ``LANE * n_shards`` so the total splits into whole
        128-element shards); ``None`` keeps the cached plan, or the default
        chunk when building fresh."""
        leaves, treedef = tree_flatten(params)
        key = (treedef, tuple(tuple(l.shape) for l in leaves),
               tuple(l.dtype for l in leaves))
        rebuild = self._flattener is None or self._flattener_key != key
        if not rebuild and chunk is not None \
                and self._flattener.chunk != int(chunk):
            rebuild = True
        if rebuild:
            self._flattener = (TreeFlattener(params) if chunk is None
                               else TreeFlattener(params, chunk=int(chunk)))
            self._flattener_key = key
        return self._flattener

    @property
    def flattener(self) -> TreeFlattener:
        if self._flattener is None:
            raise RuntimeError("no flattener yet: call init(params) first")
        return self._flattener

    def step_flat(self, state, flat_grads, *, scale=1.0, lr=None):
        raise NotImplementedError(
            f"{type(self).__name__} has no fused impl" if self.impl != "fused"
            else f"{type(self).__name__}.step_flat not implemented")

    def _prep(self, state, lr):
        """(count, lr, rc1, rc2) of the next step: the new step count, the
        learning rate (a schedule resolved at that count) and the bias
        corrections 1 / (1 - beta^t), 1 without ``bias_correction``."""
        count = state.count + 1
        lr = resolve(lr if lr is not None else self.lr, count)
        lr = lr_tensor(lr, count.device)
        if self.bias_correction:
            t = count.float()
            rc1 = 1.0 / (1.0 - torch.pow(self.beta1, t))
            rc2 = 1.0 / (1.0 - torch.pow(self.beta2, t))
        else:
            rc1 = rc2 = torch.ones((), dtype=torch.float32,
                                   device=count.device)
        return count, lr, rc1, rc2

    def model_params(self, state, dtype=None):
        """The fused state's flat master unpacked into a parameter tree,
        in ``dtype`` (default each leaf's dtype at ``init``)."""
        return self.flattener.unflatten(state.master, dtype=dtype)

    def step_flat_shard(self, state, g_shard, *, shard, scale=1.0, lr=None):
        """Sharded flat update (:mod:`~apex_tpu_torch.parallel.
        weight_update`): ``state``'s flat fields and ``g_shard`` hold this
        rank's contiguous 1/N slice of the flat buffers; ``shard`` is a
        :class:`~apex_tpu_torch.parallel.weight_update.ShardContext` (the
        group, the packing plan and the per-tensor reductions across
        shards).  The default covers every elementwise flat update: the
        slice is the full math."""
        if not self.elementwise_flat_update:
            raise NotImplementedError(
                f"{type(self).__name__} has cross-tensor reductions in its "
                "flat update and no sharded override — weight-update "
                "sharding needs a step_flat_shard implementation")
        return self.step_flat(state, g_shard, scale=scale, lr=lr)
