"""Weight-norm reparameterization (reference: ``apex/reparameterization``).

Counterpart of ``apex_tpu/reparameterization/__init__.py``.  The reference
replaces a module's ``weight`` with ``(weight_g, weight_v)`` parameters and
a forward pre-hook recomputing ``w = g * v / ||v||``
(``weight_norm.py`` ``WeightNorm.compute_weight``).  Here, as in the JAX
package, it is functional over parameter trees::

    params_wn, spec = apply_weight_norm(params, names=("w",), dim=0)
    w_full = compute_weights(params_wn, spec)     # inside the forward
    params = remove_weight_norm(params_wn, spec)  # fold back

``dim`` is the reference's: the norm runs over every dim EXCEPT ``dim``;
``dim=None`` normalises the whole tensor.  The norm is taken in fp32 and
the weight comes back in ``v``'s dtype.  Gradients reach g and v through
autograd of :func:`compute_weights`, which takes the place of the
pre-hook.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..utils.pytree import path_str, tree_map_with_path

__all__ = ["apply_weight_norm", "remove_weight_norm", "compute_weight",
           "compute_weights", "init_weight_norm"]


def _norm_except(v: torch.Tensor, dim) -> torch.Tensor:
    """||v|| in fp32 over every dim except ``dim`` (kept as size 1), or
    over the whole tensor (0-d) for ``dim=None``."""
    v32 = v.float()
    if dim is None:
        return torch.sqrt((v32 * v32).sum())
    d = dim % v.dim()
    axes = [a for a in range(v.dim()) if a != d]
    return torch.sqrt((v32 * v32).sum(dim=axes, keepdim=True))


def compute_weight(g: torch.Tensor, v: torch.Tensor, dim=0) -> torch.Tensor:
    """w = g * v / ||v||, in ``v``'s dtype."""
    return (g.float() * (v.float() / _norm_except(v, dim))).to(v.dtype)


def init_weight_norm(w: torch.Tensor, dim=0) -> dict:
    """The (g, v) pair that reproduces ``w``: ``{"weight_g": ||w|| in
    w's dtype, "weight_v": w}``."""
    return {"weight_g": _norm_except(w, dim).to(w.dtype), "weight_v": w}


def apply_weight_norm(params, names: Sequence[str] = ("w", "weight",
                                                      "kernel"),
                      dim=0):
    """Replace each leaf of ndim >= 2 whose last path segment EQUALS one of
    ``names`` by its ``{weight_g, weight_v}`` dict.  Returns ``(new_params,
    spec)``, ``spec`` mapping each replaced leaf's '/'-joined path to
    ``dim``, for :func:`compute_weights` / :func:`remove_weight_norm`."""
    spec = {}

    def tx(path, leaf):
        name = path_str(path)
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 2 \
                and name.rsplit("/", 1)[-1] in names:
            spec[name] = dim
            return init_weight_norm(leaf, dim)
        return leaf

    return tree_map_with_path(tx, params), spec


def _is_wn(x) -> bool:
    return isinstance(x, dict) and set(x) == {"weight_g", "weight_v"}


def compute_weights(params, spec):
    """Every (g, v) pair of ``params`` materialised as its weight: the
    pre-hook's work, to call at the top of a forward (differentiable in g
    and v)."""
    def tx(path, leaf):
        if _is_wn(leaf):
            return compute_weight(leaf["weight_g"], leaf["weight_v"],
                                  spec.get(path_str(path), 0))
        return leaf
    return tree_map_with_path(tx, params, is_leaf=_is_wn)


def remove_weight_norm(params, spec):
    """Fold every (g, v) pair back into its plain weight."""
    return compute_weights(params, spec)
