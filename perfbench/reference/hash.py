"""The attention-dropout keep mask: a squirrel3-style uint32 hash of
(head, query row, key column, seed), computed in int64 masked to 32 bits.

Copied from apex_tpu_torch/contrib/multihead_attn/flash.py:171-206
(``_mul32``, ``_u32``, ``_dropout_keep``), which the flash kernels compute
bit for bit; frozen here so that the reference works the mask out itself."""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(a, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def dropout_keep(seed: int, bh: torch.Tensor, rows: int, cols: int,
                 rate: float) -> torch.Tensor:
    """Keep mask (float32, (len(bh), rows, cols)) of heads ``bh`` (the
    flattened batch x head index, (n, 1, 1) int64)."""
    device = bh.device
    r = torch.arange(rows, device=device)[:, None]
    c = torch.arange(cols, device=device)[None, :]
    x = (_mul32(r & _M32, 0x9E3779B1) + _mul32(c & _M32, 0x85EBCA77)
         + _mul32(_u32(seed), 0xC2B2AE3D)) & _M32
    x = _mul32(x, 0xB5297A4D)
    x = x ^ _mul32(_u32(bh), 0x27D4EB2F)
    x = x ^ (x >> 8)
    x = (x + 0x68E31DA4) & _M32
    x = x ^ ((x << 8) & _M32)
    x = _mul32(x, 0x1B56C4E9)
    x = x ^ (x >> 8)
    return (x >= int(rate * (2 ** 32))).to(torch.float32)


def layer_seeds(generator: torch.Generator, layers: int):
    """One int32 seed a layer, drawn as the program's transformer draws
    them from the dropout generator it is handed (a CPU generator)."""
    return torch.randint(-2 ** 31, 2 ** 31, (layers,),
                         generator=generator).tolist()
