"""Parameter trees as nested dicts: their tensors and dotted paths in
sorted-key order, the order both the references and the readings use."""
from __future__ import annotations

from typing import List

import torch


def leaves(tree) -> List[torch.Tensor]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves(v) if isinstance(v, dict) else [v])
    return out


def paths(tree, prefix: str = "") -> List[str]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}{k}"
        out.extend(paths(v, p + ".") if isinstance(v, dict) else [p])
    return out
