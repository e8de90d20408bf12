"""m:n structured-sparsity masks.

Counterpart of ``apex_tpu/contrib/sparsity/sparse_masklib.py`` (the
reference's ``apex/contrib/sparsity/sparse_masklib.py`` ``create_mask``):
every group of m consecutive elements along the pruned axis keeps the
pattern of n ones, out of all C(m, n), with the largest kept |weight| mass.

A pattern's score is a sum of n fp32 absolute values.  The JAX package
takes it as a product with the 0/1 pattern matrix; here it is n gathers and
their sum, so no TF32 or other reduced-precision product enters (the sum of
two values, m4n2, rounds once either way), and the masks are the JAX
package's bit for bit.  Ties go to the first pattern in
:func:`_valid_patterns`' order, as ``jnp.argmax`` and ``torch.argmax``
both give them.

Axis convention: the reference prunes along the contraction dim, the last
one of torch's ``(out, in)`` layout; the JAX package's (and this port's)
weights are ``(..., in, out)``, so :func:`create_mask` takes ``axis`` and
:class:`~apex_tpu_torch.contrib.sparsity.ASP` passes ``-2``.
"""
from __future__ import annotations

import functools
from itertools import permutations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["create_mask", "mn_1d_best", "m4n2_1d"]


@functools.lru_cache(maxsize=None)
def _valid_patterns(m: int, n: int) -> np.ndarray:
    """All distinct m-length binary vectors with exactly n ones, as (P, m)
    float32, in the JAX package's order (``compute_valid_1d_patterns``)."""
    base = [1.0] * n + [0.0] * (m - n)
    pats = sorted(set(permutations(base)), reverse=True)
    return np.asarray(pats, np.float32)


def mn_1d_best(matrix: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """Best m:n mask along the LAST axis of a 2-D matrix, fp32 0/1.  Groups
    of m consecutive elements keep their n largest-|value| entries (the
    pattern with the largest kept mass).  A ragged tail is zero-padded, so
    the padding prefers to be masked."""
    pats_np = _valid_patterns(m, n)
    pats = torch.from_numpy(pats_np).to(matrix.device)           # (P, m)
    ones = torch.from_numpy(np.nonzero(pats_np)[1].reshape(len(pats_np), n)
                            ).to(matrix.device)                    # (P, n)
    r, c = matrix.shape
    pad = (-c) % m
    mat = matrix.float().abs()
    if pad:
        mat = F.pad(mat, (0, pad))
    groups = mat.reshape(-1, m)                                    # (G, m)
    kept = groups[:, ones]                                         # (G, P, n)
    scores = kept[..., 0]
    for j in range(1, n):
        scores = scores + kept[..., j]                             # (G, P)
    best = torch.argmax(scores, dim=1)                             # (G,)
    return pats[best].reshape(r, c + pad)[:, :c]


def m4n2_1d(matrix: torch.Tensor, density: float = 0.5) -> torch.Tensor:
    return mn_1d_best(matrix, 4, 2)


_PATTERNS = {"m4n2_1d": m4n2_1d}


def create_mask(tensor: torch.Tensor, pattern="m4n2_1d",
                density: float = 0.5, axis: int = -2) -> torch.Tensor:
    """A mask of ``tensor``'s shape, dtype and device with the m:n pattern
    applied along ``axis``.  Any rank >= 1; the other dims are flattened
    into rows.  ``pattern`` is a name or a callable ``(matrix, density) ->
    mask``."""
    if isinstance(pattern, str):
        if pattern not in _PATTERNS:
            raise ValueError(f"unknown sparsity pattern {pattern!r}; "
                             f"have {sorted(_PATTERNS)}")
        if density != 0.5:
            raise ValueError(
                f"pattern {pattern!r} has fixed density 0.5 (n/m); "
                f"got density={density}")
        fn = _PATTERNS[pattern]
    else:
        fn = pattern
    if tensor.dim() == 0:
        raise ValueError("cannot sparsify a scalar")
    ax = axis % tensor.dim() if tensor.dim() > 1 else 0
    moved = torch.movedim(tensor.detach(), ax, -1)
    flat = moved.reshape(-1, moved.shape[-1])
    mask = fn(flat, density).reshape(moved.shape)
    return torch.movedim(mask, -1, ax).to(tensor.dtype).contiguous()
