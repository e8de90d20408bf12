"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  The CPU is
used only when the caller asks for it (the tests do); a request for CUDA on
a host without it raises instead of falling back.  :func:`from_numpy`
carries the JAX package's arrays (as numpy) onto a device.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["resolve_device", "from_numpy"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``"cuda"``.  Raises ``RuntimeError`` when CUDA is
    asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but torch.cuda is not "
            "available on this host; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def from_numpy(tree, device=None):
    """A tree (dicts, lists, tuples; ``None`` kept) of numpy arrays, or of
    anything ``np.asarray`` takes, as new tensors on ``device`` (default
    ``"cuda"``), same structure and values; a bfloat16 array (the JAX
    package's, through ``ml_dtypes``) becomes a ``torch.bfloat16`` one."""
    dev = resolve_device(device)

    def conv(t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(dev,
                                                             torch.bfloat16)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return conv(tree)
