"""Flat-buffer packing of parameter trees: the multi-tensor engine's layout.

Counterpart of ``apex_tpu/multi_tensor_apply/flattener.py``, with the same
layout so a flat buffer means the same thing in both packages:

- leaves in JAX's order (dict keys sorted, :mod:`apex_tpu_torch.utils.
  pytree`), each starting on a LANE = 128 element boundary, so per-tensor
  reductions (LAMB trust ratios) are row sums over a static row range;
- the total padded to a whole number of DEFAULT_CHUNK elements (at least
  one chunk), the padding zero.

The plan (offsets, row ranges) is computed once per tree structure on the
host; packing and unpacking are tensor copies on the leaves' device.  A
template leaf may be a ``meta`` tensor: only its shape and dtype are read.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.pytree import tree_flatten, tree_unflatten, treedef_leaves

__all__ = ["TreeFlattener", "LANE", "DEFAULT_CHUNK"]

LANE = 128                   # per-leaf alignment quantum
DEFAULT_CHUNK = 128 * 1024   # the total is a whole number of these


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class TreeFlattener:
    """Packing plan for one tree structure.  All leaves pack into one
    buffer of ``dtype`` (default fp32, the master-weight layout)."""

    def __init__(self, tree, dtype=torch.float32, chunk: int = DEFAULT_CHUNK):
        leaves, self.treedef = tree_flatten(tree)
        if chunk % LANE:
            raise ValueError(f"chunk must be a multiple of {LANE}")
        self.dtype = dtype
        self.chunk = int(chunk)
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [int(np.prod(s)) if len(s) else 1 for s in self.shapes]
        self.padded_sizes = [_round_up(s, LANE) for s in self.sizes]
        self.offsets = np.concatenate(
            [[0], np.cumsum(self.padded_sizes)]).astype(np.int64)
        used = int(self.offsets[-1])
        self.total = max(_round_up(used, self.chunk), self.chunk)
        self.num_chunks = self.total // self.chunk
        self.num_leaves = len(leaves)

        # row (= LANE elements) -> leaf index; padding rows map to
        # num_leaves and drop out of every per-tensor reduction
        rows = self.total // LANE
        row_seg = np.full((rows,), self.num_leaves, dtype=np.int64)
        self.leaf_row_ranges = []
        for i, (off, size) in enumerate(zip(self.offsets[:-1], self.sizes)):
            r0 = off // LANE
            r1 = (off + _round_up(size, LANE)) // LANE
            row_seg[r0:r1] = i
            self.leaf_row_ranges.append((int(r0), int(r1)))
        self._row_segments = row_seg
        self._row_seg_on: Dict[torch.device, torch.Tensor] = {}

    def _segments(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._row_seg_on:
            self._row_seg_on[device] = torch.from_numpy(
                self._row_segments).to(device)
        return self._row_seg_on[device]

    # -- packing -------------------------------------------------------------

    def flatten(self, tree) -> torch.Tensor:
        """Pack tree -> (total,) buffer of ``self.dtype``, zero padding, on
        the leaves' device."""
        leaves = treedef_leaves(self.treedef, tree)
        device = leaves[0].device if leaves else torch.device("cpu")
        out = torch.zeros(self.total, dtype=self.dtype, device=device)
        for leaf, off, size in zip(leaves, self.offsets[:-1], self.sizes):
            out[int(off):int(off) + size].copy_(leaf.reshape(-1))
        return out

    def unflatten(self, flat: torch.Tensor, like=None, dtype=None):
        """Unpack (total,) buffer -> tree of new tensors.  Per-leaf dtype:
        explicit ``dtype`` > the matching leaf of ``like`` > the dtypes
        recorded at build time."""
        like_leaves = (treedef_leaves(self.treedef, like)
                       if like is not None else None)
        leaves = []
        for i in range(self.num_leaves):
            off = int(self.offsets[i])
            if dtype is not None:
                tgt = dtype
            elif like_leaves is not None:
                tgt = like_leaves[i].dtype
            else:
                tgt = self.dtypes[i]
            piece = flat[off:off + self.sizes[i]].view(self.shapes[i])
            leaves.append(piece.to(tgt, copy=True))
        return tree_unflatten(self.treedef, leaves)

    # -- per-tensor reductions ----------------------------------------------

    def _ranges(self, rows):
        """Each leaf's row range, clipped to the window ``rows = (lo, hi)``
        and made relative to it (all of the buffer when None)."""
        if rows is None:
            return self.leaf_row_ranges
        lo, hi = rows
        return [(min(max(r0, lo), hi) - lo, min(max(r1, lo), hi) - lo)
                for r0, r1 in self.leaf_row_ranges]

    def per_tensor_sumsq(self, flat: torch.Tensor, rows=None) -> torch.Tensor:
        """Per-leaf sum of squares (num_leaves,) fp32: row sums, then each
        leaf's static row range, in a fixed order.  With ``rows = (lo,
        hi)``, ``flat`` holds only those rows of the buffer (a ZeRO shard)
        and each leaf sums its part of them."""
        if not self.leaf_row_ranges:
            return torch.zeros(0, dtype=torch.float32, device=flat.device)
        row_sums = flat.view(-1, LANE).float().square().sum(dim=1)
        return torch.stack([row_sums[r0:r1].sum()
                            for r0, r1 in self._ranges(rows)])

    def per_tensor_maxabs(self, flat: torch.Tensor) -> torch.Tensor:
        """Per-leaf max |x| (num_leaves,) fp32; padding is 0, which cannot
        exceed a true max-abs."""
        if not self.leaf_row_ranges:
            return torch.zeros(0, dtype=torch.float32, device=flat.device)
        row_max = flat.view(-1, LANE).float().abs().amax(dim=1)
        return torch.stack([row_max[r0:r1].amax()
                            for r0, r1 in self.leaf_row_ranges])

    def broadcast_rows(self, values: torch.Tensor, rows=None) -> torch.Tensor:
        """(num_leaves,) -> (rows,) per-row values (0 on padding rows); with
        ``rows = (lo, hi)``, those rows only."""
        vals = torch.cat([values.float(),
                          torch.zeros(1, dtype=torch.float32,
                                      device=values.device)])
        seg = self._segments(values.device)
        return vals[seg if rows is None else seg[rows[0]:rows[1]]]

    def broadcast_per_tensor(self, values: torch.Tensor) -> torch.Tensor:
        """(num_leaves,) -> (total,): each leaf's value on its elements."""
        return self.broadcast_rows(values).repeat_interleave(LANE)
