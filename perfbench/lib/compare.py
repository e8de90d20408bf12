"""The comparison that decides ``correct``.

A training cell compares the program's first three steps with the
reference's: each step's loss, the first gradient as the optimizer got it
(read from its first moment after one step) and each parameter's change
over the three steps.  Gradients and changes are compared by the worst
leaf: the gap between the program's norm and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change."""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch

#: leaves whose reference first gradient is under this share of the
#: median leaf's are left out of the change comparison
NOUGHT = 1e-3
LANE = 128
#: what a missing or non-finite number reads as (JSON has no infinity)
NOT_A_READING = 1e300


def flat_offsets(sizes: Sequence[int]) -> List[int]:
    """Offsets of leaves packed one after another, each starting on a
    128-element boundary: the flat layout the fused optimizers document
    (apex_tpu_torch/multi_tensor_apply/flattener.py:5-9)."""
    out, off = [], 0
    for n in sizes:
        out.append(off)
        off += -(-n // LANE) * LANE
    return out


def flat_leaf_norms(flat: torch.Tensor, sizes: Sequence[int],
                    minus: Optional[List[torch.Tensor]] = None
                    ) -> List[float]:
    """Each leaf's norm in a flat buffer (of its difference from the leaf
    of ``minus``, when given)."""
    offs = flat_offsets(sizes)
    if flat.numel() < offs[-1] + sizes[-1]:
        raise ValueError(f"flat buffer of {flat.numel()} elements is "
                         f"shorter than the leaves it should hold")
    out = []
    for i, (o, n) in enumerate(zip(offs, sizes)):
        x = flat[o:o + n].float()
        if minus is not None:
            x = x - minus[i].reshape(-1).float()
        out.append(float(x.norm()))
    return out


def leaf_norms(leaves, minus=None) -> List[float]:
    return [float((a.float() - (0 if minus is None else minus[i].float()))
                  .norm()) for i, a in enumerate(leaves)]


def rel_gap(got: float, ref: float) -> float:
    return abs(got - ref) / abs(ref) if ref else math.inf


def worst_leaf_gap(got: Sequence[float], ref: Sequence[float],
                   include: Optional[Sequence[bool]] = None) -> float:
    if len(got) != len(ref):
        return math.inf
    med = statistics.median(ref)
    gaps = [abs(g - r) / max(r, med) if max(r, med) > 0 else math.inf
            for i, (g, r) in enumerate(zip(got, ref))
            if include is None or include[i]]
    return max(gaps) if gaps else math.inf


def median_leaf_gap(got: Sequence[float], ref: Sequence[float]) -> float:
    """The median over leaves of the same gap: steady where a few leaves'
    gradients are near-cancelling sums that rounding alone dominates."""
    if len(got) != len(ref):
        return math.inf
    med = statistics.median(ref)
    return statistics.median(abs(g - r) / max(r, med) if max(r, med) > 0
                             else math.inf for g, r in zip(got, ref))


def moved(ref_grad_norms: Sequence[float]) -> List[bool]:
    """Which leaves the change comparison counts: a reference gradient of
    at least :data:`NOUGHT` of the median leaf's."""
    med = statistics.median(ref_grad_norms)
    return [g >= NOUGHT * med for g in ref_grad_norms]


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> List[dict]:
    """Each number beside its limit; a number missing from ``readings``
    or not finite fails, and reads :data:`NOT_A_READING`."""
    out = []
    for name, limit in limits.items():
        v = readings.get(name, NOT_A_READING)
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            v = NOT_A_READING
        out.append({"name": name, "value": v, "limit": limit,
                    "ok": v <= limit})
    return out
