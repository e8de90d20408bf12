"""ASP: automatic 2:4 structured sparsity over parameter trees.

Counterpart of ``apex_tpu/contrib/sparsity/asp.py`` (the reference's
``apex/contrib/sparsity/asp.py``).  The reference is a class-level
singleton that registers mask buffers on modules and patches
``optimizer.step`` to multiply the gradients by the mask before the step
and the parameters after it.  Here, as in the JAX package, that contract is
explicit state::

    asp = ASP()                                   # pattern + layer policy
    asp.init_model_for_pruning(params)            # record eligibility
    masks = asp.compute_sparse_masks(params)      # mask tree
    params = asp.prune(params, masks)             # apply the masks once
    opt = asp.wrap_optimizer(FusedAdam(...), masks)   # steps keep sparsity

Masks are a plain tree: save them with the parameters, or recompute them
from the loaded (already pruned) parameters, where a pruned weight's mask
recomputes to itself.

Eligibility: floating leaves with ndim >= 2 whose pruned dim (``axis``,
default -2, the contraction dim of the ``(..., in, out)`` layout) is a
multiple of 4 and whose output dim a multiple of 8, filtered by
``allowed_layer_names`` / ``disallowed_layer_names`` substrings of the
leaf's '/'-joined path.

Under amp's flat fast path (an optimizer with ``impl="fused"``),
:meth:`SparseOptimizer.step_flat` masks the flat gradients and the flat
fp32 master through the wrapped optimizer's flattener, and the
attributes amp reads (``impl``, ``flattener_for``) reach the wrapped
optimizer.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ...utils.pytree import path_str, tree_leaves_with_path, tree_map, \
    tree_map_with_path
from .sparse_masklib import create_mask

__all__ = ["ASP", "SparseOptimizer"]


class ASP:
    """One instance is one sparsity policy: the pattern, the layers it
    takes, the pruned axis."""

    def __init__(self, mask_calculator="m4n2_1d", verbosity: int = 0,
                 allowed_layer_names: Optional[Sequence[str]] = None,
                 disallowed_layer_names: Sequence[str] = (),
                 custom_eligible: Optional[Callable] = None,
                 axis: int = -2):
        self.mask_calculator = mask_calculator
        self.verbosity = verbosity
        self.allowed = (tuple(allowed_layer_names)
                        if allowed_layer_names is not None else None)
        self.disallowed = tuple(disallowed_layer_names)
        self.custom_eligible = custom_eligible
        self.axis = axis
        self._eligible_paths: Optional[frozenset] = None

    def _default_eligible(self, name: str, leaf) -> bool:
        if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2 \
                or not leaf.is_floating_point():
            return False
        # the pruned dim % 4, the output dim (the trailing dim not pruned)
        # % 8, as the JAX package's tensor-core divisibility gate
        prune_ax = self.axis % leaf.dim()
        out_ax = leaf.dim() - 1 if prune_ax != leaf.dim() - 1 \
            else leaf.dim() - 2
        if leaf.shape[prune_ax] % 4 != 0 or leaf.shape[out_ax] % 8 != 0:
            return False
        if self.allowed is not None and not any(
                a in name for a in self.allowed):
            return False
        return not any(d in name for d in self.disallowed)

    def init_model_for_pruning(self, params) -> "ASP":
        """Record which leaves are sparsifiable.  Idempotent; returns
        self."""
        pred = self.custom_eligible or self._default_eligible
        eligible = []
        for path, leaf in tree_leaves_with_path(params):
            name = path_str(path)
            if pred(name, leaf):
                eligible.append(name)
                if self.verbosity >= 3:
                    print(f"[ASP] sparsifying {name} {tuple(leaf.shape)}")
            elif self.verbosity >= 3:
                print(f"[ASP] NOT sparsifying {name} "
                      f"{tuple(getattr(leaf, 'shape', ()))}")
        self._eligible_paths = frozenset(eligible)
        return self

    def _require_init(self):
        if self._eligible_paths is None:
            raise RuntimeError("call ASP.init_model_for_pruning(params) "
                               "first (the reference's ordering contract)")

    def compute_sparse_masks(self, params):
        """The mask tree: the m:n mask of each eligible leaf, ones
        elsewhere; each mask in its leaf's dtype and on its device."""
        self._require_init()

        def mk(path, leaf):
            if path_str(path) in self._eligible_paths:
                return create_mask(leaf, self.mask_calculator,
                                   axis=self.axis)
            return torch.ones_like(leaf)
        return tree_map_with_path(mk, params)

    @staticmethod
    def prune(tree, masks):
        """The masks applied to a tree (parameters or gradients)."""
        return tree_map(lambda t, m: t * m.to(t.dtype), tree, masks)

    def wrap_optimizer(self, optimizer, masks) -> "SparseOptimizer":
        """The wrapped optimizer: gradients masked before each update,
        parameters after it."""
        self._require_init()
        return SparseOptimizer(optimizer, masks)


class SparseOptimizer:
    """The wrapped optimizer's ``init`` / ``step`` / ``step_flat`` with the
    masks applied: gradients before the update, the new parameters (or the
    flat fp32 master) after it.  Every other attribute is the wrapped
    optimizer's."""

    def __init__(self, optimizer, masks):
        self.optimizer = optimizer
        self.masks = masks
        self._flat_mask = None

    def __getattr__(self, name):
        if name in ("optimizer", "masks", "_flat_mask"):
            raise AttributeError(name)      # not set yet (a copy, a load)
        return getattr(self.optimizer, name)

    def init(self, params):
        return self.optimizer.init(params)

    def step(self, state, grads, params, **kw):
        grads = ASP.prune(grads, self.masks)
        new_params, new_state = self.optimizer.step(state, grads, params,
                                                    **kw)
        return ASP.prune(new_params, self.masks), new_state

    def update(self, grads, state, params):
        """optax-style: (new params - params, new state), masked."""
        new_params, new_state = self.step(state, grads, params)
        return tree_map(lambda n, p: n - p, new_params, params), new_state

    def _mask_flat(self):
        if self._flat_mask is None:
            self._flat_mask = self.optimizer.flattener.flatten(self.masks)
        return self._flat_mask

    def step_flat(self, state, flat_grads, **kw):
        """The flat path: masked gradients in, masked flat master out."""
        m = self._mask_flat()
        new_state = self.optimizer.step_flat(state, flat_grads * m, **kw)
        return new_state._replace(master=new_state.master * m)
