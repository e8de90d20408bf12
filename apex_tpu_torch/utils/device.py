"""Device resolution for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``.  The CPU is
used only when the caller asks for it (the tests do); a request for CUDA on
a host without it raises instead of falling back.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


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
